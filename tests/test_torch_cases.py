"""The shipped cases of the ninth breadth item through both solo drivers,
on temporary copies in float64 on the CPU (the JAX driver compiled with
most XLA optimizations off).

* ``cases/tc4`` (topography, T/S and sponge from files, Z*): every
  ocean.stats line has the same step, day and truncation count; the
  energy per mass agrees to 1e-9 relative, the max CFL to 1e-9, the
  mean sea level to 1e-12 m and the mass error to 1e-12; the total
  mass, salinity and temperature as printed (as tests/test_torch_solo.py
  holds double_gyre).  The lines equal chip_smoke.py's TC4_JAX_STATS,
  which the card's run is held to.
* ``cases/tc1`` (adiabatic, GINT layers on a spoon) the same way.
* ``cases/tc2`` (PPM_H4 over the spoon's vanished layers) runs finite
  through the port's driver, with the step and day columns of the JAX
  driver's run of it (chip_smoke.py's TC2_JAX_STEPS; its other columns
  part from its own eager arithmetic, NaN under most XLA optimizations
  off).

``cases/ref_tc4`` is in tests/test_torch_ref_tc4.py.
"""

import os
import pathlib
import runpy
import shutil

import jax
import numpy as np
import pytest
import torch

from mom6_tpu.drivers import solo as jsolo

import chip_smoke
from mom6_torch.drivers import solo

# one intra-op thread: the test workers share the machine's cores, and
# an idle torch pool spins beside the other workers' XLA threads
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _stats(path):
    """{step: {field: printed text}} of an ocean.stats file."""
    out = {}
    for line in pathlib.Path(path).read_text().splitlines()[2:]:
        step, day, truncs, *rest = [c.strip() for c in line.split(",")]
        row = {"day": day, "truncs": truncs}
        row.update(c.split(None, 1) for c in rest)
        out[int(step)] = row
    return out


def _compare(got, want, steps):
    assert sorted(got) == sorted(want) == steps
    for n, w in want.items():
        g = got[n]
        for k in ("day", "truncs", "M", "S", "T"):
            assert g[k] == w[k], (n, k)
        en_w, en_g = float(w["En"]), float(g["En"])
        assert abs(en_g - en_w) <= 1e-9 * abs(en_w), (n, en_g, en_w)
        assert abs(float(g["CFL"]) - float(w["CFL"])) <= 1e-9, n
        assert abs(float(g["SL"]) - float(w["SL"])) <= 1e-12, n
        assert abs(float(g["Me"]) - float(w["Me"])) <= 1e-12, n


def _copy(case, dest, inputs=False):
    """The case's MOM_input (and MOM_override) in ``dest``; with
    ``inputs``, ref_tc4's input files, made by its gen_data.py (they are
    not in the repository)."""
    dest.mkdir(parents=True, exist_ok=True)
    for f in os.listdir(ROOT / "cases" / case):
        if f.startswith("MOM_") and not f.startswith("MOM_parameter"):
            shutil.copy(ROOT / "cases" / case / f, dest / f)
    if inputs:
        runpy.run_path(str(ROOT / "cases" / case / "gen_data.py"))["gen"](
            str(dest))
    return dest


def _both(tmp_path, case, days, cwd, inputs=False):
    """Both drivers on copies of ``case`` for ``days``, run from ``cwd``
    (a function of the copy: the directory that INPUTDIR is relative
    to); returns (JAX copy, port copy, port summary)."""
    old_cwd = os.getcwd()
    runs = []
    old = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        for name, main in (("jax", jsolo.main), ("port", solo.main)):
            d = _copy(case, tmp_path / name, inputs)
            os.chdir(cwd(d))
            runs.append((d, main([str(d), "--days", days, "--cpu"])))
    finally:
        os.chdir(old_cwd)
        jax.config.update("jax_disable_most_optimizations", old)
    return runs[0][0], runs[1][0], runs[1][1]


@pytest.mark.parametrize("case,days,steps", [("tc4", "0.05", [0, 2, 4, 6]),
                                             ("tc1", "0.125", [0, 4, 8])])
def test_case_stats_match_jax(tmp_path, case, days, steps):
    jd, pd, run = _both(tmp_path, case, days, lambda d: ROOT)
    _compare(_stats(pd / "ocean.stats"), _stats(jd / "ocean.stats"), steps)
    assert bool(torch.isfinite(run["state"].h).all())
    if case == "tc4":
        rows = chip_smoke.TC4_JAX_STATS.splitlines()
        assert (jd / "ocean.stats").read_text().splitlines()[2:] == rows


def test_tc2_runs_finite(tmp_path):
    d = _copy("tc2", tmp_path / "port")
    run = solo.main([str(d), "--cpu"])
    assert run["steps"] == 24
    s = run["state"]
    for k in ("h", "u", "v", "T", "S"):
        assert bool(torch.isfinite(getattr(s, k)).all()), k
    got = _stats(d / "ocean.stats")
    assert [(n, float(r["day"])) for n, r in sorted(got.items())] \
        == chip_smoke.TC2_JAX_STEPS
    assert all(np.isfinite(float(r[k])) for r in got.values()
               for k in ("En", "CFL", "SL", "S", "T"))
