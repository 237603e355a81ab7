"""Ocean-only driver: reads a case directory, builds the model and runs
the time loop.

Counterpart of ``mom6_tpu.drivers.solo``: reads ``MOM_input`` (and
``MOM_override`` when present) from the case directory, builds the
model (``model.build_model``), runs the time loop with the
ENERGYSAVEDAYS cadence of ``ocean.stats`` (header, truncations, mass
error), the CPU_stats/MAXCPU budget and the DTBT_RESET_PERIOD
re-estimate of the barotropic substep count (an increase applies at
once, a decrease only when it saves two substeps or more; one step
closure per substep count, reused on revisits; none under unsplit
dynamics), and writes
``MOM_parameter_doc.all``/``.short``, ``RESTART/MOM.res`` at the end of
the run (restartable with ``--restart-from``, in either package) and
``clocks.txt``, all into the case directory: point it at a copy of a
case.  The step_MOM and ocean.stats clocks synchronize the card before
they stop, so on the card ``clocks.txt`` shows their device time.

Usage::

    python -m mom6_torch.drivers.solo CASE_DIR [--days D] [--cpu]
        [--fp32] [--restart-from PATH]

Runs on ``cuda``, and raises when there is no card, unless ``--cpu`` is
given; float64 unless ``--fp32``.  With a ``diag_table`` in the case
directory, or DIAG_AS_CHKSUM, the prognostic diagnostics (with their
NK_ZSPACE z levels) are posted at each stats interval and flushed at
the end: to ``diags.nc``, or under DIAG_AS_CHKSUM as checksum lines in
``chksum_diag``.  DEBUG appends the checksums of u, v, h, T and S after
every step to ``chksum_debug``, and U_TRUNC_FILE the worst column after
every step that truncated velocities.  The restart carries the
stochastic pattern (``carry_sppt``, or ``carry_sppt_p``/``carry_sppt_k``
with SKEB) and the internal-tide energy (``carry_iten``) as the JAX
driver does; like it, the driver writes no periodic restarts, whatever
RESTINT says.  READ_DEPTH_LIST reads the APE's depth list from
DEPTH_LIST_FILE in the case directory when it matches the bathymetry,
and writes it otherwise; under DEBUG_NANS a step whose outputs hold a
NaN runs again with every operation checked, and the first that makes a
NaN raises (``framework/debug_nans.py``).  WRITE_OFFLINE_FIELDS
writes the transports and end thickness of every thermodynamic interval
to ``off_sum.nc`` and ``off_snap.nc`` in the case directory; under
OFFLINE_TRACER_MODE the driver advances only the registered tracers,
from those files in OFFLINEDIR (``tracer/offline.py``), looping over
their NUMTIME records with DT_OFFLINE steps, writes the tracers' totals
to ``ocean.stats`` at the end of each loop and the tracers to the
restart.  USE_PARTICLES seeds drifters on the cell centres of a
PARTICLES_NX x PARTICLES_NY lattice in PARTICLES_LAYER, advects them
after every step (``tracer/particles.py``, the ``particles`` clock) and
writes their positions of every stats interval to ``particles.nc``
(``part_x``, ``part_y`` over (rec, particle), in cell units).  Any
parameter the case sets that neither the builder nor the driver reads
raises ``NotImplementedError``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from mom6_torch.diagnostics.depth_list import depth_list_setup
from mom6_torch.diagnostics.point_accel import dump_worst_column
from mom6_torch.diagnostics.prognostic_diags import PrognosticDiags
from mom6_torch.diagnostics.sum_output import (collect_stats,
                                               format_stats_header,
                                               format_stats_line, stat_sums)
from mom6_torch.framework.checksums import hchksum_str
from mom6_torch.framework.clock import clock
from mom6_torch.framework.config import ParamFile
from mom6_torch.framework.debug_nans import NanCheck, has_nan
from mom6_torch.framework.diag import DiagMediator, parse_diag_table
from mom6_torch.framework.error_handler import (MOM_error, NOTE,
                                                set_verbosity)
from mom6_torch.framework.io import read_field, write_fields
from mom6_torch.framework.restart import restore_restart, save_restart
from mom6_torch.model import build_model
from mom6_torch.tracer.offline import OfflineCfg, step_offline
from mom6_torch.tracer.particles import advect_particles, init_particles

__all__ = ["read_driver_params", "main"]

_CARRIES = ("u", "v", "mld", "kv", "iten", "sppt")
# the SPPT and SKEB patterns of a {"sppt", "skeb"} carry, saved as two
# single-tensor trees
_PATTERN_PAIR = {"sppt_p": "sppt", "sppt_k": "skeb"}


def read_driver_params(pf: ParamFile, model) -> dict:
    """Every parameter read the solo driver owns beyond the builder's,
    with the JAX driver's names, defaults and units; returns them as a
    dict."""
    p = {}
    pf.module("MOM_diag_mediator")
    p["as_chksum"] = pf.get("DIAG_AS_CHKSUM", bool, False)
    p["nz_diag"] = pf.get("NK_ZSPACE", int, model.vgrid.nk,
                          desc="z levels for _z diagnostics")
    pf.module("MOM_particles")
    p["use_particles"] = pf.get("USE_PARTICLES", bool, False)
    if p["use_particles"]:
        p["particles_nx"] = pf.get("PARTICLES_NX", int, 8)
        p["particles_ny"] = pf.get("PARTICLES_NY", int, 8)
        p["particles_layer"] = pf.get("PARTICLES_LAYER", int, 0)
    pf.module("MOM")
    p["offline_mode"] = pf.get("OFFLINE_TRACER_MODE", bool, False)
    p["off_cfg"] = None
    if p["offline_mode"]:
        pf.module("MOM_offline")
        p["off_cfg"] = dict(
            dir=pf.get("OFFLINEDIR", str, pf.get("INPUTDIR", str, ".")),
            sum_file=pf.get("OFF_SUM_FILE", str, "off_sum.nc"),
            snap_file=pf.get("OFF_SNAP_FILE", str, "off_snap.nc"),
            numtime=pf.get("NUMTIME", int, 0,
                           desc="time levels before looping back"),
            dt_offline=pf.get("DT_OFFLINE", float, model.dt_therm,
                              units="s"))
    p["write_offline"] = pf.get(
        "WRITE_OFFLINE_FIELDS", bool, False,
        desc="write OFF_SUM/OFF_SNAP files from this online run")
    pf.module("MOM_sum_output")
    # ENERGYSAVEDAYS counts TIMEUNIT seconds like DAYMAX
    timeunit = pf.get("TIMEUNIT", float, 86400.0, units="s")
    p["energysavedays"] = pf.get("ENERGYSAVEDAYS", float, 1.0,
                                 units="TIMEUNIT") * (timeunit / 86400.0)
    p["do_ape"] = pf.get("CALCULATE_APE", bool, True,
                         desc="available potential energy vs the "
                         "depth-list hypsometry in ocean.stats")
    p["read_depth_list"] = pf.get("READ_DEPTH_LIST", bool, False)
    p["depth_list_file"] = pf.get("DEPTH_LIST_FILE", str, "Depth_list.nc")
    # DEBUG: one block of prognostic checksums a step in chksum_debug
    pf.module("MOM_debugging")
    p["debug_mode"] = pf.get("DEBUG", bool, False)
    # DEBUG_NANS: a step whose outputs hold a NaN names the operation
    # that made it
    p["debug_nans"] = pf.get("DEBUG_NANS", bool, False)
    # U_TRUNC_FILE: the worst column after each step that truncated
    p["u_trunc_file"] = pf.get("U_TRUNC_FILE", str, "")
    # DTBT_RESET_PERIOD: re-estimate the barotropic substep count from
    # the evolving column thickness; 0 → every dynamics step, < 0
    # disables; a fixed DTBT > 0 is never re-estimated
    pf.module("MOM_barotropic")
    if pf.get("DTBT", float, -0.95, units="s or nondim") > 0.0:
        p["dtbt_reset"] = -1.0
    else:
        p["dtbt_reset"] = pf.get(
            "DTBT_RESET_PERIOD", float, model.dt_therm, units="s",
            desc="period between dtbt re-estimates; "
            "0 = every dynamics step, <0 disables")
    # CPU-time budget: the cumulative CPU time per stats interval goes to
    # CPU_TIME_FILE, and the run ends early if the next interval would
    # exceed MAXCPU
    pf.module("MOM_write_cputime")
    p["maxcpu"] = pf.get("MAXCPU", float, -1.0,
                         units="wall-clock seconds",
                         desc="stop before exceeding this cpu budget; "
                         "<0 disables")
    p["cpu_file"] = pf.get("CPU_TIME_FILE", str, "CPU_stats")
    # the end-of-run restart is always written; periodic ones are not,
    # whatever RESTINT says, as in the JAX driver
    pf.module("MOM_restart")
    pf.get("RESTINT", float, 0.0, units="days")
    return p


def _restore(path: str, model):
    """(state, split, tracers, carry, step0, t_days) from a restart."""
    with open(path + ".json") as f:
        saved = set(json.load(f)["trees"])
    templates = {"state": model.state, "split": model.split}
    if model.tracers and "tracers" in saved:
        templates["tracers"] = model.tracers
    leaf = torch.zeros(1, dtype=model.state.h.dtype,
                       device=model.state.h.device)
    for name in saved:
        if name == "carry_res" and model.obc is not None and model.tracers:
            # the open-boundary tracer reservoirs: name -> edge -> values
            templates[name] = model.obc.init_tracer_reservoirs(
                model.tracers)
        elif name.startswith("carry_"):
            if name[len("carry_"):] not in _CARRIES + tuple(_PATTERN_PAIR):
                raise NotImplementedError(f"restart carry {name!r}")
            templates[name] = leaf
    trees, meta = restore_restart(path, templates)
    carry = {n: trees.get(f"carry_{n}") for n in _CARRIES + ("res",)}
    if any(f"carry_{n}" in trees for n in _PATTERN_PAIR):
        carry["sppt"] = {key: trees.get(f"carry_{n}")
                         for n, key in _PATTERN_PAIR.items()}
    carry["truncs"] = int(meta.get("truncs", 0))
    return (trees["state"], trees["split"],
            trees.get("tracers", model.tracers), carry, int(meta["step"]),
            float(meta["time_days"]))


def _diag_mediator(case_dir: str, model, dp: dict):
    """The prognostic diagnostics on the case's ``diag_table``, or on
    every registered field under DIAG_AS_CHKSUM with no diag_table or a
    bare one (title and base date only); None when nothing is asked
    for."""
    path = os.path.join(case_dir, "diag_table")
    text = open(path).read() if os.path.exists(path) else None
    if text is None and not dp["as_chksum"]:
        return None
    if dp["as_chksum"] and text is not None \
            and not parse_diag_table(text)[2]:
        text = None
    med = DiagMediator(model.domain, case_dir, diag_table_text=text,
                       as_chksum=dp["as_chksum"])
    diags = PrognosticDiags.create(med, model.grid, model.vgrid,
                                   float(torch.max(model.grid.bathyT)),
                                   dp["nz_diag"])
    if not (diags.any_requested() or dp["as_chksum"]):
        return None
    return diags


def main(argv=None) -> dict:
    """Run a case.  Returns a summary: the final ``state``, ``split`` and
    ``tracers``, ``nstep_bt`` (the barotropic substep count of every
    step run; None each under unsplit dynamics), ``steps`` (steps run) and ``loop_seconds`` (the time
    loop's time; on the card from CUDA events)."""
    ap = argparse.ArgumentParser(description="mom6_torch solo ocean driver")
    ap.add_argument("case_dir")
    ap.add_argument("--days", type=float, default=None,
                    help="override DAYMAX")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    ap.add_argument("--fp32", action="store_true",
                    help="float32 in place of float64")
    ap.add_argument("--restart-from", default=None)
    args = ap.parse_args(argv)

    if args.cpu:
        device = "cpu"
    elif torch.cuda.is_available():
        device = "cuda"
    else:
        raise RuntimeError("no CUDA device: pass --cpu to run on the CPU")
    dtype = torch.float32 if args.fp32 else torch.float64

    sources = [os.path.join(args.case_dir, "MOM_input")]
    override = os.path.join(args.case_dir, "MOM_override")
    if os.path.exists(override):
        sources.append(override)
    pf = ParamFile(*sources)
    # the report (clocks.txt) covers this run alone, also when one
    # process runs several cases
    clock.reset()
    set_verbosity(pf.get("VERBOSITY", int, 2,
                         desc="0 errors, 1 +warnings, 2 +notes"))

    with clock("initialization"):
        model = build_model(pf, device=device, dtype=dtype)
    dp = read_driver_params(pf, model)
    diags = _diag_mediator(args.case_dir, model, dp)
    unused = pf.close(fatal_unused=False)
    if unused:
        raise NotImplementedError(
            f"{len(unused)} parameters that nothing reads (options not "
            "ported, or misspelled): " + ", ".join(unused))
    pf.write_docs(args.case_dir)

    daymax = args.days if args.days is not None else model.daymax
    state, split, tracers = model.state, model.split, model.tracers
    step0, t_days = 0, 0.0
    carry = None
    if args.restart_from:
        state, split, tracers, carry, step0, t_days = _restore(
            args.restart_from, model)

    if dp["offline_mode"]:
        return _run_offline(args.case_dir, model, dp["off_cfg"], tracers,
                            daymax, t_days)

    step = model.step_fn(carry=carry)
    # DTBT_RESET_PERIOD swaps between these closures, one per substep
    # count
    step_cache = {step.nstep_bt: step}
    d, g, vg, dt = model.domain, model.grid, model.vgrid, model.dt
    dlist = depth_list_setup(
        d, g, read_file=dp["read_depth_list"],
        path=os.path.join(args.case_dir, dp["depth_list_file"])) \
        if dp["do_ape"] else None
    nsteps = int(round((daymax - t_days) * 86400.0 / dt))
    summary = {"state": state, "split": split, "tracers": tracers,
               "nstep_bt": [], "steps": 0, "loop_seconds": 0.0}
    if nsteps <= 0:
        MOM_error(NOTE, f"Nothing to do: current time {t_days} days, "
                  f"DAYMAX {daymax} days, DT = {dt} s")
        return summary
    stats_every = max(1, int(round(dp["energysavedays"] * 86400.0 / dt)))
    # USE_PARTICLES: drifters seeded on the cell centres of a PARTICLES_NX
    # x PARTICLES_NY lattice in PARTICLES_LAYER, advected after every
    # step, their positions recorded every stats interval
    particles, part_traj = None, []
    if dp["use_particles"]:
        pnx, pny = dp["particles_nx"], dp["particles_ny"]
        xs, ys = np.meshgrid((np.arange(pnx) + 0.5) * d.ni / pnx,
                             (np.arange(pny) + 0.5) * d.nj / pny)
        particles = init_particles(xs.ravel(), ys.ravel(),
                                   np.full(pnx * pny, dp["particles_layer"]),
                                   device=state.h.device)
    dtbt_reset = dp["dtbt_reset"]
    maxcpu = dp["maxcpu"]

    stats_path = os.path.join(args.case_dir, "ocean.stats")
    with open(stats_path, "w") as f:
        f.write(format_stats_header())
    cpu_path = os.path.join(args.case_dir, dp["cpu_file"])
    with open(cpu_path, "w") as f:
        f.write("# step, day, cpu_total[s], cpu_per_interval[s]\n")
    on_card = state.h.is_cuda
    if on_card:
        torch.cuda.synchronize()
        ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        ev0.record()
    wall0 = time.perf_counter()
    mass0 = None
    cpu_prev = 0.0
    stopped_on_cpu = False
    nstep_bt = []
    off_records, off_last = [], None
    for n in range(step0, step0 + nsteps + 1):
        if n % stats_every == 0 and n > step0:
            # write_cputime: log the interval's cpu cost and project
            # whether another interval fits in the MAXCPU budget
            cpu_now = time.process_time()
            with open(cpu_path, "a") as f:
                f.write(f"{n}, {n * dt / 86400.0:.6f}, {cpu_now:.3f},"
                        f" {cpu_now - cpu_prev:.3f}\n")
            if maxcpu > 0.0 and cpu_now + 1.05 * (cpu_now - cpu_prev) \
                    > maxcpu:
                MOM_error(NOTE,
                          f"MAXCPU: stopping at step {n} — "
                          f"{cpu_now:.1f}s used, next interval "
                          f"(~{cpu_now - cpu_prev:.1f}s) would exceed "
                          f"the {maxcpu:.1f}s budget")
                stopped_on_cpu = True
            cpu_prev = cpu_now
        if n % stats_every == 0:
            with clock("ocean.stats", sync=lambda: state.h):
                s = collect_stats(stat_sums(d, g, vg, state, dt, dlist), vg,
                                  n, n * dt / 86400.0,
                                  truncs=step.truncations())
                if mass0 is None:
                    mass0 = s.total_mass
                line = format_stats_line(s, mass0)
                with open(stats_path, "a") as f:
                    f.write(line)
                print(line, end="")
            if diags is not None:
                with clock("diag mediator"):
                    diags.post_state(g, vg, state, eos=model.eos)
        if n == step0 + nsteps or stopped_on_cpu:
            break
        if dtbt_reset >= 0.0 and model.cfg.split and n > step0 \
                and (n - step0) % max(1, int(round(dtbt_reset / dt))) == 0:
            # asymmetric hysteresis: an increase (stability) applies at
            # once, a decrease only if it saves two substeps or more, so
            # an estimate oscillating across a ceil boundary never churns
            new_nstep = model.reset_dtbt(state)
            if new_nstep > step.nstep_bt \
                    or new_nstep <= step.nstep_bt - 2:
                MOM_error(NOTE, f"DTBT_RESET_PERIOD: nstep "
                          f"{step.nstep_bt} -> {new_nstep} at step {n}")
                acc = step.carry()
                if new_nstep in step_cache:
                    step = step_cache[new_nstep]
                    step.set_carry(acc)
                else:
                    step = model.step_fn(nstep_bt=new_nstep, carry=acc)
                    step_cache[new_nstep] = step
        truncs_before = step.truncations() if dp["u_trunc_file"] else 0
        acc_before = step.carry() if dp["debug_nans"] else None
        with clock("step_MOM", sync=lambda: state.h):
            out = step(state, split, tracers, n)
        if dp["debug_nans"] and has_nan(*out):
            # as jax_debug_nans: the step runs again from its inputs, op
            # by op, to name the operation that made the NaN
            step.set_carry(acc_before)
            with NanCheck(step=n):
                step(state, split, tracers, n)
            raise FloatingPointError(
                f"DEBUG_NANS: step {n} made a NaN outside the aten "
                "operations")
        state, split, tracers = out
        if particles is not None:
            with clock("particles"):
                particles = advect_particles(d, g, particles, state.u,
                                             state.v, dt)
            if n % stats_every == 0:
                part_traj.append((particles.x.cpu().numpy(),
                                  particles.y.cpu().numpy()))
        if dp["u_trunc_file"] and step.truncations() > truncs_before:
            dump_worst_column(
                os.path.join(args.case_dir, dp["u_trunc_file"]), d, g,
                state, n + 1,
                label=f"({step.truncations() - truncs_before} truncs)")
        nstep_bt.append(step.nstep_bt)
        if dp["write_offline"]:
            off = step.offline_fields()
            if off is not None and off is not off_last:
                off_last = off
                off_records.append(tuple(
                    d.interior(x).detach().cpu().double().numpy()
                    for x in off))
        if dp["debug_mode"]:
            # the checksum flood: one block of prognostic checksums a step
            with open(os.path.join(args.case_dir, "chksum_debug"), "a") as f:
                f.write(f"= step {n + 1}\n")
                for nm in ("u", "v", "h", "T", "S"):
                    fld = getattr(state, nm)
                    if fld is not None:
                        f.write(hchksum_str(d, fld, nm) + "\n")
    if on_card:
        ev1.record()
        torch.cuda.synchronize()
        loop_seconds = ev0.elapsed_time(ev1) / 1e3
    else:
        loop_seconds = time.perf_counter() - wall0
    if dp["write_offline"] and off_records:
        _write_offline_fields(args.case_dir, off_records)
    if part_traj:
        write_fields(os.path.join(args.case_dir, "particles.nc"),
                     {"part_x": np.stack([x for x, _ in part_traj]),
                      "part_y": np.stack([y for _, y in part_traj])},
                     dims={"part_x": ("rec", "particle"),
                           "part_y": ("rec", "particle")})
    nran = n - step0
    pts = d.ni * d.nj * vg.nk * max(nran, 1)
    print(f"run complete: {nran} of {nsteps} steps, {loop_seconds:.2f}s "
          f"wall, {pts / max(loop_seconds, 1e-9):.3g} points/s")
    if diags is not None:
        with clock("diag mediator"):
            diags.med.flush("diags.nc", time_value=daymax)

    with clock("restart save"):
        trees = {"state": state, "split": split}
        if tracers:
            trees["tracers"] = tracers
        acc = step.carry()
        for name in _CARRIES + ("res",):
            if acc.get(name) is None:
                continue
            if name == "sppt" and isinstance(acc[name], dict):
                for n, key in _PATTERN_PAIR.items():
                    if acc[name].get(key) is not None:
                        trees[f"carry_{n}"] = acc[name][key]
            else:
                trees[f"carry_{name}"] = acc[name]
        save_restart(os.path.join(args.case_dir, "RESTART", "MOM.res"), trees,
                     meta={"step": step0 + nsteps, "time_days": daymax,
                           "truncs": step.truncations()})

    report = clock.report()
    print(report, file=sys.stderr)
    with open(os.path.join(args.case_dir, "clocks.txt"), "w") as f:
        f.write(report)
    summary.update(state=state, split=split, tracers=tracers,
                   nstep_bt=nstep_bt, steps=nran, loop_seconds=loop_seconds)
    return summary


def _write_offline_fields(case_dir: str, records) -> None:
    """``off_sum.nc`` (uhtr, vhtr) and ``off_snap.nc`` (h_end) from the
    (uhtr, vhtr, h_end) records of an online run's thermodynamic
    intervals, on the compute domain."""
    uh, vh, h = (np.stack([r[i] for r in records]) for i in range(3))
    t = np.arange(len(records), dtype=np.float64)
    dims4 = ("time", "zl", "yh", "xh")
    write_fields(os.path.join(case_dir, "off_sum.nc"),
                 {"time": t, "uhtr": uh, "vhtr": vh},
                 dims={"time": ("time",), "uhtr": dims4, "vhtr": dims4},
                 attrs={"uhtr": {"units": "m3"}, "vhtr": {"units": "m3"}})
    write_fields(os.path.join(case_dir, "off_snap.nc"),
                 {"time": t, "h_end": h},
                 dims={"time": ("time",), "h_end": dims4},
                 attrs={"h_end": {"units": "m"}})
    print(f"offline fields written: {len(records)} intervals")


def _run_offline(case_dir: str, model, off: dict, tracers, daymax: float,
                 t_days: float) -> dict:
    """Offline tracer mode: the registered tracers advanced from the
    stored transports and thicknesses, looping over NUMTIME file
    records, x_first alternating by step; the tracers' totals go to
    ``ocean.stats`` and the tracers to the closing restart.  Returns the
    summary of ``main`` (``state`` and ``split`` None)."""
    if not tracers:
        raise SystemExit("OFFLINE_TRACER_MODE requires registered "
                         "tracers (e.g. USE_IDEAL_AGE_TRACER)")
    d = model.domain
    dev = dict(device=model.state.h.device, dtype=model.state.h.dtype)
    sum_path = os.path.join(off["dir"], off["sum_file"])
    snap_path = os.path.join(off["dir"], off["snap_file"])
    uh_all = np.asarray(read_field(sum_path, "uhtr"), np.float64)
    vh_all = np.asarray(read_field(sum_path, "vhtr"), np.float64)
    h_all = np.asarray(read_field(snap_path, "h_end"), np.float64)
    numtime = off["numtime"] or uh_all.shape[0]
    dt_off = off["dt_offline"]
    nsteps = int(round((daymax - t_days) * 86400.0 / dt_off))
    cfg = OfflineCfg(dt_offline=dt_off)
    area = d.interior(model.grid.areaT)
    stats_path = os.path.join(case_dir, "ocean.stats")
    with open(stats_path, "w") as f:
        f.write("# offline tracer mode: step, day, "
                + ", ".join(f"total[{k}]" for k in sorted(tracers))
                + "\n")
    wall0 = time.perf_counter()
    for n in range(nsteps):
        lvl = n % numtime
        h_end, uhtr, vhtr = (d.pad(torch.as_tensor(a[lvl], **dev))
                             for a in (h_all, uh_all, vh_all))
        tracers, h = step_offline(d, model.grid, tracers, h_end, uhtr, vhtr,
                                  None, cfg, registry=model.registry,
                                  x_first=(n % 2 == 0))
        if n % max(1, numtime) == numtime - 1 or n == nsteps - 1:
            tots = [float(torch.sum(d.interior(tracers[k] * h) * area))
                    for k in sorted(tracers)]
            line = (f"{n + 1}, {(n + 1) * dt_off / 86400.0:.4f}, "
                    + ", ".join(f"{v:.10e}" for v in tots) + "\n")
            with open(stats_path, "a") as f:
                f.write(line)
            print(line, end="")
    wall = time.perf_counter() - wall0
    print(f"offline run complete: {nsteps} steps, {wall:.2f}s wall")
    save_restart(os.path.join(case_dir, "RESTART", "MOM.res"),
                 {"tracers": tracers},
                 meta={"step": nsteps, "time_days": daymax})
    return {"state": None, "split": None, "tracers": tracers,
            "nstep_bt": [], "steps": nsteps, "loop_seconds": wall}


if __name__ == "__main__":
    main()
