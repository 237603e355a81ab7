"""Package rules of mom6_torch, checked on the CPU.

* No module of the port (nor chip_smoke.py) imports jax or mom6_tpu.
* Every module imports without nvcc, triton or a card.
* A CPU tensor through each kernel wrapper takes the plain version and
  leaves the wrapper's launch counter at 0.
* Options outside the slice raise NotImplementedError naming them, in
  the step, in the model builder and in the solo driver.
"""

import ast
import dataclasses
import importlib
import pathlib
import shutil

import numpy as np
import pytest
import torch

from mom6_torch import entry
from mom6_torch.core import continuity_cuda, barotropic_cuda
from mom6_torch.core.continuity_ppm import (ContinuityCfg, continuity_ppm,
                                            set_up_bt_cont)
from mom6_torch.core.dynamics_split_rk2 import step_dyn_split_rk2
from mom6_torch.core.dynamics_split_rk2b import step_dyn_split_rk2b
from mom6_torch.drivers import solo

# one intra-op thread: the test workers share the machine's cores, and
# an idle torch pool spins beside the other workers' XLA threads
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "mom6_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]


def _imported(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    return names


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = {n for n in _imported(path)
           if n.split(".")[0] in ("jax", "jaxlib", "mom6_tpu")}
    assert not bad, f"{path.name} imports {sorted(bad)}"


def test_guard_covers_the_builder_and_the_driver():
    for rel in ("mom6_torch/model.py", "mom6_torch/drivers/solo.py",
                "mom6_torch/framework/config.py", "chip_smoke.py"):
        assert ROOT / rel in PORT_FILES, rel


def test_every_module_imports_without_a_card():
    for path in sorted((ROOT / "mom6_torch").rglob("*.py")):
        mod = ".".join(path.relative_to(ROOT).with_suffix("").parts)
        importlib.import_module(mod.removesuffix(".__init__"))


def _small_slice():
    return entry.build(16, 12, 3, device="cpu", dtype=torch.float64)


def test_cpu_tensors_take_the_plain_versions():
    s = _small_slice()
    wrappers = (continuity_cuda.continuity_ppm_cuda,
                continuity_cuda.set_up_bt_cont_cuda,
                barotropic_cuda.subcycle_cuda)
    before = [w.launches for w in wrappers]
    g, vg, h = s.grid, s.vgrid, s.state.h
    rng = np.random.default_rng(0)
    u = s.domain.fill_halos(torch.as_tensor(
        0.1 * rng.standard_normal(h.shape)) * g.mask2dCu)
    v = s.domain.fill_halos(torch.as_tensor(
        0.1 * rng.standard_normal(h.shape)) * g.mask2dCv)
    ub = torch.sum(u * h, 0) * g.dyCu
    vb = torch.sum(v * h, 0) * g.dxCv
    cfg = ContinuityCfg()
    got = continuity_cuda.continuity_ppm_cuda(g, vg, u, v, h, s.dt, cfg,
                                              ub, vb)
    want = continuity_ppm(g, vg, u, v, h, s.dt, cfg, uhbt=ub, vhbt=vb)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    got = continuity_cuda.set_up_bt_cont_cuda(g, vg, u, v, h, s.dt, cfg)
    want = set_up_bt_cont(g, vg, u, v, h, s.dt, cfg)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    st, sp, _ = step_dyn_split_rk2(s.domain, g, vg, s.state, s.split,
                                   s.forces, s.dt, s.cfg)
    assert torch.isfinite(st.h).all()
    assert [w.launches for w in wrappers] == before


def _porous(grid):
    """The grid with ridges on every face: crests at half the depth."""
    d = grid.bathyT
    return dataclasses.replace(
        grid, porous_DminU=-d, porous_DmaxU=-0.5 * d,
        porous_DavgU=-0.75 * d, porous_DminV=-d, porous_DmaxV=-0.5 * d,
        porous_DavgV=-0.75 * d)


@pytest.mark.parametrize("option", ["upwind_1st", "simple_2nd",
                                    "monotonic", "vol_cfl"])
def test_kernel_gate_names_the_option(option):
    """The kernels take every edge scheme, the volume-based CFL and
    porous faces: the scheme goes to the kernels under its code in
    csrc/ppm.cuh, and a porous grid on the CPU takes the plain version
    in that mode (the gate that refused porous faces is gone)."""
    s = _small_slice()
    cfg = ContinuityCfg(**{option: True})
    names = {"upwind_1st": "EDGE_UPWIND", "simple_2nd": "EDGE_SIMPLE2",
             "monotonic": "EDGE_MONOTONIC", "vol_cfl": "EDGE_PPM"}
    header = (ROOT / "mom6_torch" / "csrc" / "ppm.cuh").read_text()
    assert f"{names[option]} = {continuity_cuda.edge_scheme(cfg)}" in header
    porous = _porous(s.grid)
    wrap = continuity_cuda.continuity_ppm_cuda
    before = (wrap.launches, wrap.porous_launches)
    st = s.state
    got = wrap(porous, s.vgrid, st.u, st.v, st.h, s.dt, cfg)
    want = continuity_ppm(porous, s.vgrid, st.u, st.v, st.h, s.dt, cfg)
    assert torch.equal(got.h, want.h) and torch.equal(got.uh, want.uh)
    assert (wrap.launches, wrap.porous_launches) == before


# open boundaries, once the first case here, are ported
# (tests/test_torch_obc.py), and so are GME and the stochastic EOS, once
# the second and the fourth (tests/test_torch_stochastic.py), and the
# VarMix and MEKE viscosity inputs kh_scale and kh_extra, once the fifth
# and sixth (tests/test_torch_breadth4.py); the other case keeps its id.
# The split RK2 step takes the shear viscosity kv_shear since the third
# breadth item (tests/test_torch_breadth3.py): the RK2b step, which takes
# none, as in the JAX package, still refuses it
@pytest.mark.parametrize("kw,name,stepper", [
    pytest.param(dict(kv_shear=object()), "kv_shear", step_dyn_split_rk2b,
                 id="kw2-kv_shear"),
])
def test_step_rejects_unported_options(kw, name, stepper):
    s = _small_slice()
    cfg = s.cfg
    with pytest.raises(NotImplementedError, match=name):
        stepper(s.domain, s.grid, s.vgrid, s.state, s.split, s.forces,
                s.dt, cfg, **kw)


def test_nonboussinesq_and_porous_raise():
    """Since the non-Boussinesq pressure force and porous faces are
    ported, what still raises is the reference's own exclusion: the
    Stanley correction with BOUSSINESQ = False.  The non-Boussinesq
    form gives finite forces, and the BT_cont fit on a porous grid
    takes the plain face masks, as the JAX package's does."""
    from mom6_torch.core.pressure_force import (PressureForceCfg,
                                                pressure_force)
    s = _small_slice()
    nonbouss = dataclasses.replace(s.vgrid, boussinesq=False)
    pf = pressure_force(s.grid, nonbouss, s.state.h)
    assert torch.isfinite(pf.PFu).all() and torch.isfinite(pf.pbce).all()
    with pytest.raises(ValueError, match="STANLEY"):
        pressure_force(s.grid, nonbouss, s.state.h,
                       cfg=PressureForceCfg(stanley_coeff=0.5))
    st = s.state
    got = set_up_bt_cont(_porous(s.grid), s.vgrid, st.u, st.v, st.h, s.dt)
    want = set_up_bt_cont(s.grid, s.vgrid, st.u, st.v, st.h, s.dt)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


# the diag mediator (DIAG_AS_CHKSUM, NK_ZSPACE, a diag_table) and DEBUG,
# once cases here, are ported (tests/test_torch_debug.py), and so are
# U_TRUNC_FILE, RESTINT (read and, as in the JAX driver, without periodic
# restarts) and USE_MEKE (tests/test_torch_breadth4.py), and DEBUG_NANS,
# READ_DEPTH_LIST, SPONGE and the data_table (tests/test_torch_breadth9.py),
# and offline tracer mode, WRITE_OFFLINE_FIELDS and the tracer packages
# (tests/test_torch_bgc.py), and ICE_SHELF, THICKNESS_CONFIG phillips and
# TOPO_CONFIG seamount (tests/test_torch_ice_shelf.py,
# test_torch_user_configs.py), and USE_PARTICLES, the wind configurations,
# WIND_STAGGER A and COORD_CONFIG BFB (tests/test_torch_breadth10.py,
# test_torch_coupled_oda.py, and test_driver_runs_ported_options below):
# their cases now name options still refused
@pytest.mark.parametrize("line,name", [
    ("TRIPOLAR_N = True", "TRIPOLAR_N"),
    ('MASKTABLE = "mask_table.2.4x4"', "MASKTABLE"),
    ("AUTO_MASKTABLE = True", "AUTO_MASKTABLE"),
    ("PHASED_JIT = True", "PHASED_JIT"),
])
def test_driver_rejects_unported_options(tmp_path, line, name):
    case = ROOT / "cases" / "double_gyre"
    shutil.copy(case / "MOM_input", tmp_path / "MOM_input")
    with open(tmp_path / "MOM_input", "a") as f:
        f.write(line + "\n")
    with pytest.raises(NotImplementedError, match=name):
        solo.main([str(tmp_path), "--days", "0.25", "--cpu"])
    assert not (tmp_path / "ocean.stats").exists()


# options that the driver refused until they were ported: each runs 3
# steps of cases/double_gyre
@pytest.mark.parametrize("line,out", [
    ("USE_PARTICLES = True\nPARTICLES_NX = 2\nPARTICLES_NY = 3",
     "particles.nc"),
    ('#override WIND_CONFIG = "ideal_hurr"\nIDL_HURR_X0 = 6.6e5\n'
     "IDL_HURR_Y0 = 6.0e5", "ocean.stats"),
    ('#override WIND_CONFIG = "dumbbell"', "ocean.stats"),
    ('COORD_CONFIG = "BFB"', "ocean.stats"),
    ('#override WIND_CONFIG = "SCM_CVMix_tests"\nSCM_TAU_Y = 0.05',
     "ocean.stats"),
    ('#override WIND_CONFIG = "file"\nWIND_FILE = "wind.nc"\n'
     'WIND_STAGGER = "A"', "ocean.stats"),
], ids=["particles", "ideal_hurr", "dumbbell", "coord_bfb", "scm",
        "wind_stagger_a"])
def test_driver_runs_ported_options(tmp_path, line, out):
    from mom6_torch.framework.io import write_fields
    case = ROOT / "cases" / "double_gyre"
    shutil.copy(case / "MOM_input", tmp_path / "MOM_input")
    write_fields(str(tmp_path / "wind.nc"),
                 {"STRESS_X": np.full((40, 44), 0.1),
                  "STRESS_Y": np.zeros((40, 44))},
                 dims={"STRESS_X": ("ny", "nx"), "STRESS_Y": ("ny", "nx")})
    with open(tmp_path / "MOM_input", "a") as f:
        f.write(line + f'\nINPUTDIR = "{tmp_path}"\n')
    run = solo.main([str(tmp_path), "--days", "0.0417", "--cpu"])
    assert run["steps"] == 3 and (tmp_path / out).exists()
    assert bool(torch.isfinite(run["state"].u).all())
