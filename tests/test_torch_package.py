"""Package rules of mom6_torch, checked on the CPU.

* No module of the port (nor chip_smoke.py) imports jax or mom6_tpu.
* Every module imports without nvcc, triton or a card.
* A CPU tensor through each kernel wrapper takes the plain version and
  leaves the wrapper's launch counter at 0.
* Options outside the slice raise NotImplementedError naming them.
"""

import ast
import dataclasses
import importlib
import pathlib

import numpy as np
import pytest
import torch

from mom6_torch import entry
from mom6_torch.core import continuity_cuda, barotropic_cuda
from mom6_torch.core.continuity_ppm import (ContinuityCfg, continuity_ppm,
                                            set_up_bt_cont)
from mom6_torch.core.dynamics_split_rk2 import SplitCfg, step_dyn_split_rk2
from mom6_torch.core.vert_friction import VertViscCfg

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


@pytest.mark.parametrize("option", ["upwind_1st", "simple_2nd",
                                    "monotonic", "vol_cfl"])
def test_kernel_gate_names_the_option(option):
    s = _small_slice()
    with pytest.raises(NotImplementedError, match=option):
        continuity_cuda._check_cfg(ContinuityCfg(**{option: True}), s.grid)


@pytest.mark.parametrize("kw,name", [
    (dict(obc=object()), "OBC"),
    (dict(eos=object(),
          cfg=SplitCfg(vertvisc=VertViscCfg(bbl_use_eos=True))), "EOS"),
    (dict(kv_shear=object()), "kv_shear"),
    (dict(stoch_pattern=object()), "stoch_eos"),
    (dict(cfg=SplitCfg(tides_fn=lambda e, t: e)), "tides"),
])
def test_step_rejects_unported_options(kw, name):
    s = _small_slice()
    cfg = kw.pop("cfg", s.cfg)
    if "stoch_pattern" in kw:
        cfg = SplitCfg(stoch_eos_a=0.5)
    with pytest.raises(NotImplementedError, match=name):
        step_dyn_split_rk2(s.domain, s.grid, s.vgrid, s.state, s.split,
                           s.forces, s.dt, cfg, **kw)


def test_nonboussinesq_and_porous_raise():
    from mom6_torch.core.pressure_force import pressure_force
    s = _small_slice()
    with pytest.raises(NotImplementedError, match="non-Boussinesq"):
        pressure_force(s.grid, dataclasses.replace(s.vgrid,
                                                   boussinesq=False),
                       s.state.h)
    porous = dataclasses.replace(s.grid, porous_DavgU=s.grid.bathyT)
    with pytest.raises(NotImplementedError, match="porous"):
        set_up_bt_cont(porous, s.vgrid, s.state.u, s.state.v, s.state.h,
                       s.dt)
