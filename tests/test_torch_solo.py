"""mom6_torch's solo driver against mom6_tpu's on ``cases/double_gyre``.

Both drivers run on temporary copies of ``cases/double_gyre/MOM_input``
(they write ocean.stats, RESTART/, the parameter docs and clocks.txt
into the case directory) for 0.25 days, 18 steps of 1200 s, in float64
on the CPU; the JAX driver compiles with most XLA optimizations off.

* Every ocean.stats line has the same step, day and truncation count;
  the energy per mass agrees to 1e-9 relative, the max CFL to 1e-9, the
  mean sea level (roundoff-sized, ~1e-14 m) to 1e-12 m and the mass
  error to 1e-12; the total mass, salinity and temperature as printed.
* The port restores the JAX run's RESTART/MOM.res, and that state equals
  the port's own final state to 1e-9 relative.
* The port's restart is bitwise: 9 steps, a save, a restore and 9 more
  give the state and the step-18 ocean.stats line of 18 steps straight.
* Each MOM_parameter_doc.all line of the port equals the JAX file's
  line for that parameter.
* Without --cpu the driver raises on a machine with no card.
"""

import pathlib
import shutil

import jax
import pytest
import torch

from mom6_tpu.drivers import solo as jsolo

from mom6_torch.drivers import solo
from mom6_torch.framework.config import ParamFile
from mom6_torch.model import build_model

# one intra-op thread: the test workers share the machine's cores, and
# an idle torch pool spins beside the other workers' XLA threads
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CASE = ROOT / "cases" / "double_gyre"
DAYS = "0.25"


def _case_copy(tmp_path_factory, name):
    d = tmp_path_factory.mktemp(name)
    shutil.copy(CASE / "MOM_input", d / "MOM_input")
    return d


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    d = _case_copy(tmp_path_factory, "jax_dg")
    old = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        jsolo.main([str(d), "--days", DAYS, "--cpu"])
    finally:
        jax.config.update("jax_disable_most_optimizations", old)
    return d


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    d = _case_copy(tmp_path_factory, "port_dg")
    return d, solo.main([str(d), "--days", DAYS, "--cpu"])


def _stats(path):
    """{step: {field: printed text}} of an ocean.stats file."""
    out = {}
    for line in path.read_text().splitlines()[2:]:
        step, day, truncs, *rest = [c.strip() for c in line.split(",")]
        row = {"day": day, "truncs": truncs}
        row.update(c.split(None, 1) for c in rest)
        out[int(step)] = row
    return out


def test_ocean_stats_match_jax(jax_run, port_run):
    want = _stats(jax_run / "ocean.stats")
    got = _stats(port_run[0] / "ocean.stats")
    assert sorted(got) == sorted(want) == [0, 18]
    for n, w in want.items():
        g = got[n]
        for k in ("day", "truncs", "M", "S", "T"):
            assert g[k] == w[k], (n, k)
        en_w, en_g = float(w["En"]), float(g["En"])
        assert abs(en_g - en_w) <= 1e-9 * abs(en_w), (n, en_g, en_w)
        assert abs(float(g["CFL"]) - float(w["CFL"])) <= 1e-9, n
        assert abs(float(g["SL"]) - float(w["SL"])) <= 1e-12, n
        assert abs(float(g["Me"]) - float(w["Me"])) <= 1e-12, n
    assert float(want[18]["En"]) > 0.0


def _max_rel(a, b):
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / (a.abs().max() + 1e-300))


def test_port_restores_the_jax_restart(jax_run, port_run):
    d, summary = port_run
    model = build_model(ParamFile(str(d / "MOM_input")), device="cpu",
                        dtype=torch.float64)
    state, split, _, carry, step0, days = solo._restore(
        str(jax_run / "RESTART" / "MOM.res"), model)
    assert (step0, days, carry["truncs"]) == (18, 0.25, 0)
    for k in ("u", "v", "h"):
        assert _max_rel(getattr(summary["state"], k),
                        getattr(state, k)) <= 1e-9, k
    for k in ("eta", "u_av", "v_av", "uh", "vh"):
        assert _max_rel(getattr(summary["split"], k),
                        getattr(split, k)) <= 1e-9, k


def test_port_restart_is_bitwise(port_run, tmp_path_factory):
    d_straight, straight = port_run
    d = _case_copy(tmp_path_factory, "port_dg_restart")
    solo.main([str(d), "--days", "0.125", "--cpu"])
    res = d / "RESTART" / "MOM.res"
    shutil.copy(str(res) + ".npz", d / "half.npz")
    shutil.copy(str(res) + ".json", d / "half.json")
    second = solo.main([str(d), "--days", DAYS, "--cpu",
                        "--restart-from", str(d / "half")])
    assert second["steps"] == 9
    for k in ("u", "v", "h"):
        assert torch.equal(getattr(straight["state"], k),
                           getattr(second["state"], k)), k
    for k in ("u_av", "v_av", "h_av", "uh", "vh", "eta", "diffu", "diffv"):
        assert torch.equal(getattr(straight["split"], k),
                           getattr(second["split"], k)), k
    line18 = (d_straight / "ocean.stats").read_text().splitlines()[3]
    assert (d / "ocean.stats").read_text().splitlines()[2] == line18


def _doc_lines(path):
    return {line.split(" = ", 1)[0]: line
            for line in path.read_text().splitlines()
            if " = " in line and not line.lstrip().startswith("!")}


def test_parameter_doc_matches_jax(jax_run, port_run):
    want = _doc_lines(jax_run / "MOM_parameter_doc.all")
    got = _doc_lines(port_run[0] / "MOM_parameter_doc.all")
    assert len(got) > 40
    for name, line in got.items():
        assert line == want.get(name), name


def test_main_without_cpu_needs_a_card(tmp_path, monkeypatch):
    shutil.copy(CASE / "MOM_input", tmp_path / "MOM_input")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        solo.main([str(tmp_path), "--days", DAYS])
    assert not (tmp_path / "ocean.stats").exists()


def test_unread_parameters_raise(tmp_path):
    (tmp_path / "MOM_input").write_text(
        (CASE / "MOM_input").read_text() + "SPONGE_DAMPING_FILE = x.nc\n")
    with pytest.raises(NotImplementedError, match="SPONGE_DAMPING_FILE"):
        solo.main([str(tmp_path), "--days", DAYS, "--cpu"])
