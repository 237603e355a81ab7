"""Ice-shelf-only driver (counterpart of ``mom6_tpu.drivers.shelf_solo``):
builds the horizontal grid and an ice-shelf thickness profile from a
case's MOM_input, then loops the shelf step (SSA velocities and the
advective thickness update) without an ocean, in float64.  It writes
``shelf.stats`` (step, day, ice volume, largest speed) at eight points
of the run and at its end, and ``shelf_final.nc`` (thick, u, v on the
compute domain), into the case directory.

Usage::

    python -m mom6_torch.drivers.shelf_solo CASE_DIR [--days D] [--cpu]

Runs on ``cuda``, and raises when there is no card, unless ``--cpu`` is
given.  A parameter the case sets that the driver does not read raises
``NotImplementedError``.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch

from mom6_torch.core.grid import Grid, cartesian_grid
from mom6_torch.framework.config import ParamFile
from mom6_torch.framework.io import write_fields
from mom6_torch.ice_shelf.dynamics import SSACfg
from mom6_torch.ice_shelf.shelf_main import (ShelfCfg, ShelfState,
                                             init_shelf_thickness,
                                             step_shelf)
from mom6_torch.parallel.domain import Domain

__all__ = ["ShelfCase", "build_shelf_case", "main"]


@dataclasses.dataclass
class ShelfCase:
    """What the driver builds from MOM_input."""
    domain: Domain
    grid: Grid
    cfg: ShelfCfg
    shelf: ShelfState
    dt: float
    daymax: float


def build_shelf_case(pf: ParamFile, *, device="cuda",
                     days: float | None = None) -> ShelfCase:
    """The grid (flat 1000 m bed, f = 0), the shelf configuration and the
    initial shelf of the parameters, in float64 on ``device``; ``days``
    takes the place of DAYMAX."""
    ni = pf.get("NIGLOBAL", int)
    nj = pf.get("NJGLOBAL", int)
    lenlon = pf.get("LENLON", float, float(ni))
    lenlat = pf.get("LENLAT", float, float(nj))
    west = pf.get("WESTLON", float, 0.0)
    dt = pf.get("DT_ICE_DYNAMICS", float, pf.get("DT", float, 86400.0),
                units="s")
    daymax = pf.get("DAYMAX", float, 1.0)
    if days is not None:
        daymax = days
    d = Domain(ni=ni, nj=nj, halo=4)
    grid = cartesian_grid(d, lenlon_km=lenlon, lenlat_km=lenlat, f0=0.0,
                          beta=0.0, max_depth=1000.0,
                          depth_fn=lambda lo, la: np.full_like(la, 1000.0),
                          device=device, dtype=torch.float64)
    cfg = ShelfCfg(
        ssa=SSACfg(
            glen_a=pf.get("A_GLEN_ISOTHERM", float, 2.4e-24,
                          units="Pa-3 s-1"),
            basal_beta=pf.get("BASAL_FRICTION_COEFF", float, 0.0),
            c_basal=pf.get("C_BASAL_FRICTION", float, 0.0,
                           units="Pa (m s-1)^-n"),
            n_basal=pf.get("BASAL_FRICTION_EXP", float, 1.0),
            coulomb=pf.get("USE_COULOMB_FRICTION", bool, False),
            cf_min_n=pf.get("CF_MinN", float, 1.0, units="Pa"),
            cf_post_peak=pf.get("CF_PostPeak", float, 1.0),
            cf_max=pf.get("CF_Max", float, 0.5)),
        dynamic=True,
        advance_front=pf.get("SHELF_ADVANCE_FRONT", bool, True))
    h0 = init_shelf_thickness(
        pf.get("ICE_PROFILE_CONFIG", str, "channel"), grid,
        max_thick=pf.get("SHELF_MAX_THICKNESS", float, 500.0, units="m"),
        lon_extent=pf.get("SHELF_LENGTH_LON", float, 0.5 * lenlon),
        west=west, halo=d.halo)
    # the ocean's bed (depth below sea level) for the flotation test
    bed = grid.bathyT if pf.get("SHELF_GROUNDING", bool, True) else None
    shelf = ShelfState(h_shelf=h0,
                       area_frac=(h0 > cfg.min_thickness).to(h0.dtype),
                       bed_elev=bed)
    return ShelfCase(domain=d, grid=grid, cfg=cfg, shelf=shelf, dt=dt,
                     daymax=daymax)


def main(argv=None) -> dict:
    """Run a case; returns the final ``shelf``, ``u``, ``v`` and the
    ``steps`` run."""
    ap = argparse.ArgumentParser(description="mom6_torch ice-shelf driver")
    ap.add_argument("case_dir")
    ap.add_argument("--days", type=float, default=None,
                    help="override DAYMAX")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    args = ap.parse_args(argv)
    if args.cpu:
        device = "cpu"
    elif torch.cuda.is_available():
        device = "cuda"
    else:
        raise RuntimeError("no CUDA device: pass --cpu to run on the CPU")

    pf = ParamFile(os.path.join(args.case_dir, "MOM_input"))
    case = build_shelf_case(pf, device=device, days=args.days)
    unused = pf.close(fatal_unused=False)
    if unused:
        raise NotImplementedError(
            f"{len(unused)} parameters that nothing reads (options not "
            "ported, or misspelled): " + ", ".join(unused))

    d, dt = case.domain, case.dt
    nsteps = max(1, int(round(case.daymax * 86400.0 / dt)))
    stats_path = os.path.join(args.case_dir, "shelf.stats")
    with open(stats_path, "w") as f:
        f.write("# step, day, ice volume [m3], max speed [m a-1]\n")
    shelf, u, v = case.shelf, None, None
    wall0 = time.perf_counter()
    for n in range(nsteps):
        res = step_shelf(d, case.grid, shelf, case.cfg, dt, u0=u, v0=v)
        shelf, u, v = res.state, res.u, res.v
        if n % max(1, nsteps // 8) == 0 or n == nsteps - 1:
            # the ice volume [m3] and the largest speed [m a-1]
            vol = float(torch.sum(d.interior(shelf.h_shelf
                                             * case.grid.areaT)))
            spd = float(torch.max(torch.sqrt(u * u + v * v))) * 3.15e7
            line = f"{n + 1}, {(n + 1) * dt / 86400.0:.3f}, {vol:.8e}, " \
                f"{spd:.4f}\n"
            with open(stats_path, "a") as f:
                f.write(line)
            print(line, end="")
    wall = time.perf_counter() - wall0
    print(f"shelf run complete: {nsteps} steps, {wall:.2f}s wall")
    write_fields(os.path.join(args.case_dir, "shelf_final.nc"),
                 {k: d.interior(a).detach().cpu().numpy()
                  for k, a in (("thick", shelf.h_shelf), ("u", u),
                               ("v", v))})
    return {"shelf": shelf, "u": u, "v": v, "steps": nsteps}


if __name__ == "__main__":
    main()
