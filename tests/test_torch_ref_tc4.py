"""``cases/ref_tc4`` through the port's solo driver, on a temporary copy
with its input files in float64 on the CPU: the mosaic grid, the
z-file initial state remapped onto Z*, the ALE sponge over 2 layers and
COORD_CONFIG linear.  The port's build equals the JAX builder's (the
grid, the initial state and the sponge data, 1e-12), and the driver
meets the case's golden (tests/goldens_ref_cases.json) at the
tolerances of tests/test_ref_cases.py after its 18 steps.  The JAX
driver does not run the case here: its compile alone takes most of a
minute, and tests/test_torch_cases.py holds tc4, the same modules on
another grid, to the JAX driver line by line.
"""

import json
import os

import numpy as np
import torch

from mom6_tpu.framework.config import ParamFile as JParamFile
from mom6_tpu.model import build_model as j_build_model

from test_torch_cases import ROOT, _copy

from mom6_torch.diagnostics import sum_output
from mom6_torch.drivers import solo
from mom6_torch.framework.config import ParamFile
from mom6_torch.model import build_model

# one intra-op thread: the test workers share the machine's cores, and
# an idle torch pool spins beside the other workers' XLA threads
torch.set_num_threads(1)

GOLDENS = json.loads((ROOT / "tests" / "goldens_ref_cases.json").read_text())


def test_ref_tc4_golden_and_jax(tmp_path):
    g = GOLDENS["ref_tc4"]
    d = _copy("ref_tc4", tmp_path, inputs=True)
    old_cwd = os.getcwd()
    os.chdir(d)
    try:
        m = build_model(ParamFile(str(d / "MOM_input"),
                                  str(d / "MOM_override")),
                        device="cpu", dtype=torch.float64)
        jm = j_build_model(JParamFile(str(d / "MOM_input"),
                                      str(d / "MOM_override")))
        run = solo.main([str(d), "--cpu", "--days",
                         repr(g["nsteps"] * m.dt / 86400.0)])
    finally:
        os.chdir(old_cwd)
    assert run["steps"] == g["nsteps"]
    assert m.cfg.sponge is not None and "ref_h" in m.cfg.sponge
    pairs = [(f"grid {k}", getattr(jm.grid, k), getattr(m.grid, k))
             for k in ("geoLonT", "geoLatT", "dxT", "dyT", "areaT",
                       "bathyT")]
    pairs += [(f"initial {k}", getattr(jm.state, k), getattr(m.state, k))
              for k in ("h", "T", "S")]
    pairs += [(f"sponge {k}", jm.ocean_cfg.sponge_data[k], m.cfg.sponge[k])
              for k in ("idamp", "T", "S", "ref_h")]
    for name, want, got in pairs:
        want = np.asarray(want, np.float64)
        err = np.abs(got.numpy() - want).max() / (np.abs(want).max()
                                                   + 1e-300)
        assert err <= 1e-12, (name, err)
    s = run["state"]
    st = sum_output.collect_stats(
        sum_output.stat_sums(m.domain, m.grid, m.vgrid, s, m.dt), m.vgrid,
        g["nsteps"], 0.0)
    np.testing.assert_allclose(st.energy_per_mass, g["energy_per_mass"],
                               rtol=1e-9)
    np.testing.assert_allclose(st.total_mass, g["mass"], rtol=1e-11)
    np.testing.assert_allclose(st.mean_salin, g["salt"], atol=1e-9)
    np.testing.assert_allclose(st.mean_temp, g["temp"], rtol=1e-9)
    np.testing.assert_allclose(st.max_cfl, g["max_cfl"], rtol=1e-6,
                               atol=1e-12)
    np.testing.assert_allclose(st.mean_sea_level, g["sea_level"],
                               rtol=1e-6, atol=1e-12)
