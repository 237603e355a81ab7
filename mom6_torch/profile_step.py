"""Where the time of one step goes on a CUDA card.

    python -m mom6_torch.profile_step [--full [--layered]
                                     [--dynamics rk2|rk2b|unsplit|b1|
                                                 nonbouss|obc|stoch|b3|
                                                 b3pp81|bml|b4|b4v|hybgen|
                                                 adapt|unmix|file|bgc|
                                                 shelf|hurr]]
                                     [--ni 512 --nj 512 --nk 25]
                                     [--steps 10] [--out DIR]
                                     [--count-ops]

Builds the kernels and runs, in fp32, slice 1 of ``mom6_torch.entry``
(``build``: the split RK2 dynamics step) or, with ``--full``, slice 2
(``build_full``: the full ocean step of the benchmark configuration,
with Z* ALE, or its layered variant with ``--layered``; a thermodynamic
step every second step), on the split RK2 dynamics or, with
``--dynamics``, on the split RK2b or the unsplit RK3 dynamics
(``build_full(dynamics=...)``: the unsplit text steps 20 s with a
thermodynamic step every sixth), or on the split RK2 dynamics with the
first breadth item's options (``b1``: tides with spherical-harmonic
SAL, Stanley, porous barriers, ZB2020/Leith; ``nonbouss``: the
non-Boussinesq step), or on the regional configuration with open
boundaries (``obc``: adiabatic and layered, with K3's open-face
instance and the dyed OBC tracers), or with the rest of the first
breadth item (``stoch``: THICKNESSDIFFUSE_FIRST, DIABATIC_FIRST, GME,
Stanley with STOCH_EOS, SPPT and SKEB), or with the column physics of
the third (``b3``: ePBL, kappa-shear and the rest with Z* ALE;
``b3pp81``: PP81 in place of kappa-shear; ``bml``: layered, the bulk
mixed layer), or with the lateral parameterizations of the fourth
(``b4``: MEKE, VarMix, neutral and boundary diffusion, the interface
filter and the internal tides with Z* ALE; ``b4v``: layered, the
Visbeck diffusivities and the mixed layer's epipycnal diffusion), or
set up and forced from files (``file``: the ALE sponge, the file wind
and buoyancy fluxes interpolated in time, the data_table's overrides),
or with biogeochemistry (``bgc``: the MARBL-shaped coupler's column
physics and its restoring remap, with 13 passive tracers), or under an
ice shelf (``shelf``: its pressure, stress shielding and melt fluxes,
the ``ice_shelf/fluxes`` range), or under a translating hurricane
(``hurr``: the ``forcing/hurricane`` range inside the step's
``forcing``).
After two warm-up steps it
measures:

1. the step time, by CUDA events around ``--steps`` uninstrumented
   steps (with ``--full`` also per kind of step: thermodynamic and
   dynamics-only);
2. one step of each kind under ``torch.profiler`` with a
   ``record_function`` range around every top-level phase (slice 1: the
   phases of ``step_dyn_split_rk2`` and the barotropic subcycle inside
   btstep; slice 2: the dynamics, thickness diffusion, MLE, tracer
   advection, tracer_hordiff, the diabatic driver and the ALE
   regrid/remap of ``step_ocean``, and inside them the dynamics'
   pressure force, Coriolis, viscosities, btstep, the K3/K3m subcycle,
   KPP, the tidal geopotential, the continuity kernels and, on a
   porous grid, the plain computation of each K1 sweep's open
   fractions; the stochastic patterns, SPPT, SKEB, the Stanley terms,
   the STOCH_EOS multiplier and GME's inputs and stress; set_diffusivity,
   kappa-shear, ePBL, the bulk mixed layer, diffusive entrainment, full
   convection and frazil inside the diabatic driver; VarMix's resolution
   function and Eady rate, the MEKE step, the interface filter, neutral
   and boundary diffusion, the mixed layer's epipycnal diffusion and the
   internal tides with their wave speeds). Each device
   kernel is charged
   to the innermost range whose host range issued its launch, which
   gives per phase: host milliseconds (the range on the host clock,
   profiler on, inclusive of the ranges inside it), device milliseconds
   (its own kernels' durations) and kernel count; and for the step:
   device busy time and idle share (host clock, profiler on, which
   inflates host time).

Prints the tables and, last, one JSON line; with ``--out`` the
profiler's chrome traces are kept there.  A profiler that records no
device activity is reported as such.

With ``--full --count-ops`` it runs on the CPU instead, needing no card,
and counts the aten operators (CUDA kernel launches, near enough) of a
thermodynamic and of a dynamics-only step, in all and inside each range,
with a ``TorchDispatchMode`` (small ``--ni``/``--nj`` give the counts of
the full width: they depend on the layers, not on the points).
"""

from __future__ import annotations

import argparse
import collections
import functools
import json
import os
import tempfile
import time

import torch

from mom6_torch import cuda_build, entry
from mom6_torch.ale import ale_main, regridding
from mom6_torch.core import barotropic_cuda, continuity_cuda
from mom6_torch.core import dynamics_split_rk2 as dyn
from mom6_torch.core import dynamics_split_rk2b as dyn_b
from mom6_torch.core import dynamics_unsplit as dyn_u
from mom6_torch.core import orchestrator as orch
from mom6_torch.core import pressure_force as pfm
from mom6_torch.drivers import surface_forcing as sf
from mom6_torch.eos.poly import Poly3
from mom6_torch.framework.data_override import DataOverride
from mom6_torch.framework.interp_external import ExternalField
from mom6_torch.ice_shelf import shelf_main
from mom6_torch.model import Model
from mom6_torch.param.lateral import hor_visc as hvm
from mom6_torch.param.vertical import diabatic as dia
from mom6_torch.param.vertical import set_diffusivity as sdm
from mom6_torch.parallel.domain import Domain
from mom6_torch.tracer import hor_diff as hdm
from mom6_torch.tracer.marbl_driver import BGCCoupler, RestoringData

# (module, function, range name): the functions wrapped in a range
SLICE1 = tuple((dyn, n, n) for n in (
    "pressure_force", "coriolis_adv", "horizontal_viscosity",
    "set_viscous_bbl", "vertvisc_coef", "vertvisc", "vertvisc_remnant",
    "vertvisc_limit_vel", "set_up_bt_cont_cuda", "btstep",
    "continuity_ppm_cuda")) + (
    (barotropic_cuda, "subcycle_cuda", "btstep/subcycle_cuda"),
    (Domain, "fill_halos_group", "fill_halos_group"))
# slice 2: the dynamics of each stepper, by its module and function...
DYNAMICS = {"rk2": (dyn, "step_dyn_split_rk2"),
            "rk2b": (dyn_b, "step_dyn_split_rk2b"),
            "unsplit": (dyn_u, "step_dyn_unsplit"),
            "b1": (dyn, "step_dyn_split_rk2"),
            "nonbouss": (dyn, "step_dyn_split_rk2"),
            "obc": (dyn, "step_dyn_split_rk2"),
            "stoch": (dyn, "step_dyn_split_rk2"),
            "b3": (dyn, "step_dyn_split_rk2"),
            "b3pp81": (dyn, "step_dyn_split_rk2"),
            "bml": (dyn, "step_dyn_split_rk2"),
            "b4": (dyn, "step_dyn_split_rk2"),
            "b4v": (dyn, "step_dyn_split_rk2"),
            "hybgen": (dyn, "step_dyn_split_rk2"),
            "adapt": (dyn, "step_dyn_split_rk2"),
            "unmix": (dyn, "step_dyn_split_rk2"),
            "file": (dyn, "step_dyn_split_rk2"),
            "bgc": (dyn, "step_dyn_split_rk2"),
            "shelf": (dyn, "step_dyn_split_rk2"),
            "hurr": (dyn, "step_dyn_split_rk2")}
DYN_PHASES = ("pressure_force", "coriolis_adv", "horizontal_viscosity",
              "vertvisc", "btstep", "continuity_ppm_cuda",
              "set_up_bt_cont_cuda", "tidal_geopotential",
              "stoch_eos_multiplier", "gme_inputs")
# ... and the phases of step_ocean after it
SLICE2 = (
    (orch, "thickness_diffuse", "thickness_diffuse"),
    (orch, "mixed_layer_restrat", "mixed_layer_restrat"),
    (orch, "advect_tracers", "advect_tracers"),
    (orch, "tracer_hordiff", "tracer_hordiff"),
    (orch, "diabatic", "diabatic"),
    (dia, "kpp_coefficients", "diabatic/kpp_coefficients"),
    # the column physics of the third breadth item
    (dia, "set_diffusivity", "diabatic/set_diffusivity"),
    (sdm, "kappa_shear_coeffs", "diabatic/set_diffusivity/kappa_shear"),
    (dia, "energetic_pbl", "diabatic/energetic_pbl"),
    (dia, "full_convection", "diabatic/full_convection"),
    (dia, "make_frazil", "diabatic/make_frazil"),
    (dia, "bulk_mixed_layer", "diabatic/bulk_mixed_layer"),
    (dia, "entrainment_diffusive", "diabatic/entrainment_diffusive"),
    (dia, "regularize_layers", "diabatic/regularize_layers"),
    (orch, "ale_regrid_remap", "ale"),
    # the stochastic pieces: the patterns, SPPT's and SKEB's updates, the
    # Stanley terms of the pressure force and GME's stress
    (orch, "init_pattern", "pattern/init_pattern"),
    (orch, "step_pattern", "pattern/step_pattern"),
    (orch, "apply_sppt", "apply_sppt"),
    (orch, "apply_skeb", "apply_skeb"),
    (pfm, "calc_varT", "dynamics/pressure_force/calc_varT"),
    (pfm, "density_second_dT2",
     "dynamics/pressure_force/density_second_dT2"),
    (hvm, "_gme_stress", "dynamics/horizontal_viscosity/gme_stress"),
    # the lateral parameterizations of the fourth breadth item
    (orch, "calc_resolution_function", "varmix/resolution_function"),
    (orch, "calc_eady_rate", "varmix/eady_rate"),
    (orch, "step_meke", "meke/step_meke"),
    (orch, "interface_filter", "interface_filter"),
    (orch, "neutral_diffusion", "neutral_diffusion"),
    (orch, "hor_bnd_diffusion", "hor_bnd_diffusion"),
    (hdm, "ml_epipycnal_diff", "tracer_hordiff/ml_epipycnal_diff"),
    (orch, "_internal_tides", "internal_tides"),
    (orch, "wave_speeds", "internal_tides/wave_speeds"),
    (orch, "step_internal_tides", "internal_tides/step_internal_tides"),
    # the hybrid coordinates of the sixth breadth item inside the ALE
    # call, and the polynomial equations of state of the fifth wherever
    # they are called (their kernels are charged to this range, not to
    # the phase that calls them)
    (ale_main, "hybgen_unmix", "ale/hybgen_unmix"),
    (ale_main, "build_grid", "ale/build_grid"),
    (regridding, "hybgen_regrid", "ale/build_grid/hybgen_regrid"),
    (regridding, "_build_adapt", "ale/build_grid/build_adapt"),
    (ale_main, "remap_column_means", "ale/remap_column_means"),
    (Poly3, "__call__", "eos_poly"),
    # the ninth breadth item: the sponges, the file forcing's records
    # interpolated in time, and the data_table's overrides
    (orch, "apply_sponge", "sponge"),
    (orch, "apply_eta_sponge", "sponge_eta"),
    (ExternalField, "at", "file_forcing"),
    (DataOverride, "mech", "data_override/mech"),
    (DataOverride, "fluxes", "data_override/fluxes"),
    # the seventh breadth item: the BGC coupler's column physics and, in
    # it, the restoring's remap from the file's z-grid
    (BGCCoupler, "column_physics", "bgc"),
    (RestoringData, "tendencies", "bgc/restoring"),
    # the ice shelf's coupling: its pressure, the stress shielding and
    # the three-equation melt of the forcing
    (Model, "shelf_forcing", "ice_shelf/fluxes"),
    # the step's forcing, and in it the hurricane's stress at the u and
    # v points of the tenth breadth item
    (Model, "forcing", "forcing"),
    (sf, "_hurricane_stress", "forcing/hurricane"))
# the shelf-only step (drivers/shelf_solo.py): its SSA solve
SHELF_SOLO = ((shelf_main, "ssa_velocity_solve", "ice_shelf/ssa"),)


def slice2_targets(dynamics: str):
    """The ranges of a full step on ``dynamics``: the stepper, each of
    its phases the stepper's module calls, the K3/K3m subcycle, and the
    phases of step_ocean."""
    mod, fn = DYNAMICS[dynamics]
    return ((orch, fn, "dynamics"),) + tuple(
        (mod, n, f"dynamics/{n}") for n in DYN_PHASES if hasattr(mod, n)) + (
        (barotropic_cuda, "subcycle_cuda", "dynamics/btstep/subcycle_cuda"),
        (barotropic_cuda, "subcycle_march_cuda",
         "dynamics/btstep/subcycle_march_cuda"),
        (continuity_cuda, "porous_factor",
         "dynamics/continuity_ppm_cuda/porous_factor")) + SLICE2


# the ranges whose device kernels are also listed by kernel name
KERNEL_SPLIT = ("continuity_ppm_cuda", "set_up_bt_cont_cuda")


def _ranged(name, fn):
    # functools.wraps also copies attributes such as a kernel wrapper's
    # launch counter, which the wrapped code increments
    @functools.wraps(fn)
    def ranged(*args, **kw):
        with torch.profiler.record_function(name):
            return fn(*args, **kw)
    return ranged


def _kernel_name(name: str) -> str:
    """``void (anonymous namespace)::f<float>(float const*, ...)`` ->
    ``f<float>``."""
    name = name.replace("(anonymous namespace)::", "")
    return name.split("(", 1)[0].removeprefix("void ").strip()


def _attribute(trace: dict, names):
    """({phase: [host_us, device_us, kernels, calls]}, busy_us,
    {phase: {kernel: [count, device_us]}}) from a chrome trace: kernels
    are matched to their launch by correlation id and charged to the
    innermost phase range containing the launch."""
    ev = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    ranges = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in ev
                    if e.get("cat") == "user_annotation"
                    and e["name"] in names)
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in ev
                 if e.get("cat") == "cuda_runtime"
                 and "correlation" in e.get("args", {})}
    out = collections.defaultdict(lambda: [0.0, 0.0, 0, 0])
    by_kernel = collections.defaultdict(
        lambda: collections.defaultdict(lambda: [0, 0.0]))
    for t0, t1, name in ranges:
        out[name][0] += t1 - t0
        out[name][3] += 1
    busy = 0.0
    for e in ev:
        if e.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        busy += e["dur"]
        ts = launch_ts.get(e.get("args", {}).get("correlation"))
        inside = [r for r in ranges if ts is not None and r[0] <= ts <= r[1]]
        owner = min(inside, key=lambda r: r[1] - r[0])[2] if inside \
            else "other (between phases)"
        out[owner][1] += e["dur"]
        out[owner][2] += 1
        k = by_kernel[owner][_kernel_name(e["name"])]
        k[0] += 1
        k[1] += e["dur"]
    return out, busy, by_kernel


def _profile(step, targets, label, out_dir):
    """One step under the profiler with a range around every target;
    returns the summary dict of that step."""
    saved = [(obj, n, getattr(obj, n)) for obj, n, _ in targets]
    for (obj, n, fn), (_, _, rname) in zip(saved, targets):
        setattr(obj, n, _ranged(rname, fn))
    from torch.profiler import ProfilerActivity, profile
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            prof_ms = (time.perf_counter() - t0) * 1e3
    finally:
        for obj, n, fn in saved:
            setattr(obj, n, fn)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(out_dir or tmp, f"profile_step_{label}.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    phases, busy_us, by_kernel = _attribute(trace,
                                            {r for _, _, r in targets})
    summary = dict(profiled_step_ms=prof_ms, device_busy_ms=busy_us / 1e3)
    if busy_us <= 0.0:
        print(f"{label}: torch.profiler recorded no device activity: busy "
              "time and idle share not measured")
        return summary
    summary["idle_share_profiled"] = 1.0 - busy_us / 1e3 / prof_ms
    summary["kernels"] = sum(v[2] for v in phases.values())
    summary["phases"] = {k: dict(host_ms=v[0] / 1e3, device_ms=v[1] / 1e3,
                                 kernels=v[2], calls=v[3])
                         for k, v in phases.items()}
    print(f"{label} step profiled: {prof_ms:.3f} ms (host clock, profiler "
          f"on), device busy {busy_us / 1e3:.3f} ms, idle share "
          f"{summary['idle_share_profiled']:.1%}, {summary['kernels']} "
          "device kernels")
    print(f"{'phase':42s} {'calls':>5s} {'host ms':>8s} "
          f"{'device ms':>9s} {'kernels':>7s} {'dev share':>9s}")
    for k, v in sorted(phases.items(), key=lambda kv: -kv[1][1]):
        print(f"{k:42s} {v[3]:5d} {v[0] / 1e3:8.3f} {v[1] / 1e3:9.3f} "
              f"{v[2]:7d} {v[1] / busy_us:9.1%}")
    # the device kernels of the continuity kernels' own ranges (K1, K2)
    split = {p: {n: dict(count=c, device_ms=us / 1e3)
                 for n, (c, us) in ks.items()}
             for p, ks in by_kernel.items()
             if p.endswith(KERNEL_SPLIT)}
    for p, ks in sorted(split.items()):
        print(f"{p}: " + "; ".join(
            f"{n} x{v['count']} {v['device_ms']:.4f} ms"
            for n, v in sorted(ks.items(), key=lambda kv: -kv[1]
                               ["device_ms"])))
    summary["kernel_split"] = split
    return summary


def count_ops(step, kind, targets, per_kind: int = 1) -> dict:
    """The aten operators each kind of step dispatches (on CUDA tensors
    each is one kernel launch, near enough), in all and inside each
    range of ``targets`` (inclusive of the ranges inside it), counted by
    a ``TorchDispatchMode`` over ``per_kind`` steps of each kind; runs
    on any device."""
    from torch.utils._python_dispatch import TorchDispatchMode
    stack, counts = [], collections.Counter()

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            counts["step"] += 1
            for r in set(stack):
                counts[r] += 1
            return func(*args, **(kwargs or {}))

    def counted(name, fn):
        @functools.wraps(fn)
        def inner(*args, **kw):
            stack.append(name)
            try:
                return fn(*args, **kw)
            finally:
                stack.pop()
        return inner

    saved = [(obj, n, getattr(obj, n)) for obj, n, _ in targets]
    out = {}
    try:
        for obj, n, r in targets:
            setattr(obj, n, counted(r, getattr(obj, n)))
        for want in ("dynamics-only", "thermo"):
            counts.clear()
            for _ in range(per_kind):
                while kind() != want:
                    step()
                with Count():
                    step()
            out[want] = {k: v / per_kind for k, v in counts.items()}
    finally:
        for obj, n, fn in saved:
            setattr(obj, n, fn)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--full", action="store_true",
                   help="profile slice 2, the full ocean step")
    p.add_argument("--layered", action="store_true",
                   help="with --full: the layered variant (no ALE)")
    p.add_argument("--dynamics", choices=sorted(DYNAMICS), default="rk2",
                   help="with --full: the dynamics stepper")
    p.add_argument("--ni", type=int, default=512)
    p.add_argument("--nj", type=int, default=512)
    p.add_argument("--nk", type=int, default=25)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--out", default=None)
    p.add_argument("--count-ops", action="store_true",
                   help="with --full: count the aten operators of each "
                   "kind of step and of each range, on the CPU")
    a = p.parse_args(argv)
    dev = "cpu" if a.count_ops else "cuda"
    if a.count_ops and not a.full:
        raise SystemExit("profile_step: --count-ops needs --full")
    if not a.count_ops:
        if not torch.cuda.is_available():
            raise SystemExit("profile_step: needs a CUDA card")
        cuda_build.build()
    if a.full:
        m = entry.build_full(a.ni, a.nj, a.nk, regridding=not a.layered,
                             dynamics=a.dynamics, device=dev,
                             dtype=torch.float32)
        full_step = m.step_fn()
        cur = [m.state, m.split, m.tracers]
        n_done = [0]

        def step():
            cur[:] = full_step(*cur, n_done[0])
            n_done[0] += 1

        def kind():
            return "thermo" if (n_done[0] + 1) % m.cfg.n_dyn_per_therm \
                == 0 else "dynamics-only"
        targets = slice2_targets(a.dynamics)
        if a.count_ops:
            for _ in range(2):
                step()
            ops = count_ops(step, kind, targets)
            for k, c in ops.items():
                print(f"{a.dynamics} {a.nk}x{a.nj}x{a.ni}, a {k} step: "
                      f"{c['step']:.0f} aten ops; " + ", ".join(
                          f"{r} {v:.0f}" for r, v in sorted(c.items())
                          if r != "step"))
            print(json.dumps(dict(dynamics=a.dynamics,
                                  shape=[a.nk, a.nj, a.ni], aten_ops=ops)))
            return
    else:
        s = entry.build(a.ni, a.nj, a.nk, device="cuda",
                        dtype=torch.float32)
        cur = [s.state, s.split]

        def step():
            st, sp, _ = dyn.step_dyn_split_rk2(s.domain, s.grid, s.vgrid,
                                               *cur, s.forces, s.dt, s.cfg)
            cur[:] = [st, sp]

        def kind():
            return "dynamics"
        targets = SLICE1

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    name = torch.cuda.get_device_name(0)

    # 1. uninstrumented step time, each step between two CUDA events
    events = [torch.cuda.Event(enable_timing=True)
              for _ in range(a.steps + 1)]
    kinds = []
    t0 = time.perf_counter()
    events[0].record()
    for i in range(a.steps):
        kinds.append(kind())
        step()
        events[i + 1].record()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / a.steps
    per = [events[i].elapsed_time(events[i + 1]) for i in range(a.steps)]
    step_ms = sum(per) / a.steps
    by_kind = {k: sum(t for t, kk in zip(per, kinds) if kk == k)
               / kinds.count(k) for k in dict.fromkeys(kinds)}
    # the open-boundary and bulk-mixed-layer texts are layered whatever
    # --layered says
    ale = a.full and not a.layered and a.dynamics not in ("obc", "bml")
    label = ("slice 2 (full step, " + ("ALE" if ale else "layered")
             + f", {a.dynamics})") if a.full else "slice 1"
    print(f"{name}: {label} "
          f"{a.nk}x{a.nj}x{a.ni} fp32, {step_ms:.3f} ms/step (CUDA "
          f"events), {wall_ms:.3f} ms/step (host clock), mean of "
          f"{a.steps} steps; "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in by_kind.items()))
    summary = dict(device=name, slice=2 if a.full else 1,
                   ale=ale,
                   dynamics=a.dynamics if a.full else "rk2",
                   shape=[a.nk, a.nj, a.ni], step_ms=step_ms,
                   step_ms_by_kind=by_kind, host_ms_per_step=wall_ms)

    # 2. one profiled step of each kind, with a range around every phase
    wrapped = [(obj, n, _ranged(r, getattr(obj, n)))
               for obj, n, r in targets]
    saved = [(obj, n, getattr(obj, n)) for obj, n, _ in targets]
    for obj, n, fn in wrapped:        # warm the wrapped path once
        setattr(obj, n, fn)
    try:
        step()
    finally:
        for obj, n, fn in saved:
            setattr(obj, n, fn)
    torch.cuda.synchronize()
    summary["profiled"] = {}
    for want in dict.fromkeys(kinds):
        while kind() != want:       # step on to a step of that kind
            step()
        summary["profiled"][want] = _profile(step, targets, want, a.out)
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
