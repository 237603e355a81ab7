"""``cases/ref_tc3`` (circle_obcs: four Flather/Orlanski open edges
around a cosine-bell interface bump, COORD_CONFIG layer_ref, the DOME
dyes, DEBUG and DIAG_AS_CHKSUM) through the port's solo driver on a
temporary copy, in float64 on the CPU: the build equals the JAX
builder's (the target densities, the initial thicknesses and the DOME
dyes, 1e-12) with every parameter read, the options are active as
tests/test_ref_cases.py checks them, and the driver meets the case's
golden (tests/goldens_ref_cases.json) at that file's tolerances after
its 6 steps.
"""

import json

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


def test_ref_tc3_golden_and_jax(tmp_path):
    g = GOLDENS["ref_tc3"]
    d = _copy("ref_tc3", tmp_path)
    files = (str(d / "MOM_input"), str(d / "MOM_override"))
    pf = ParamFile(*files)
    m = build_model(pf, device="cpu", dtype=torch.float64)
    solo.read_driver_params(pf, m)
    assert set(pf.close(fatal_unused=False)) <= {"INPUTDIR"}
    jm = j_build_model(JParamFile(*files))
    # the options of tests/test_ref_cases.py's ref_tc3 check
    assert m.obc is not None
    assert m.tracers is not None and list(m.tracers) == ["dome_dye1",
                                                         "dome_dye2"]
    h = m.domain.interior(m.state.h).numpy()
    assert h[0].max() > h[0].min() + 1.0
    nk = m.vgrid.nk
    np.testing.assert_array_equal(m.vgrid.Rlay.numpy(),
                                  1030.0 + 2.0 * np.arange(nk) / (nk - 1))
    pairs = [("Rlay", jm.vgrid.Rlay, m.vgrid.Rlay),
             ("g_prime", jm.vgrid.g_prime, m.vgrid.g_prime),
             ("h", jm.state.h, m.state.h)]
    pairs += [(k, jm.tracers[k], m.tracers[k]) for k in jm.tracers]
    for name, want, got in pairs:
        want = np.asarray(want, np.float64)
        err = np.abs(got.numpy() - want).max() / (np.abs(want).max()
                                                   + 1e-300)
        assert err <= 1e-12, (name, err)

    run = solo.main([str(d), "--cpu"])
    assert run["steps"] == g["nsteps"]
    s = run["state"]
    assert torch.isfinite(s.h).all()
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
    # the dyes moved with the flow and stayed in [0, 1]
    dyes = run["tracers"]
    assert not torch.equal(dyes["dome_dye1"], m.tracers["dome_dye1"])
    for v in dyes.values():
        v = m.domain.interior(v)
        assert float(v.min()) >= -1e-12 and float(v.max()) <= 1.0 + 1e-12
