"""Where the time of one step goes on a CUDA card.

    python -m mom6_torch.profile_step [--full [--layered]]
                                     [--ni 512 --nj 512 --nk 25]
                                     [--steps 10] [--out DIR]

Builds the kernels and runs, in fp32, slice 1 of ``mom6_torch.entry``
(``build``: the split RK2 dynamics step) or, with ``--full``, slice 2
(``build_full``: the full ocean step of the benchmark configuration,
with Z* ALE, or its layered variant with ``--layered``; a thermodynamic
step every second step).  After two warm-up steps it
measures:

1. the step time, by CUDA events around ``--steps`` uninstrumented
   steps (with ``--full`` also per kind of step: thermodynamic and
   dynamics-only);
2. one step of each kind under ``torch.profiler`` with a
   ``record_function`` range around every top-level phase (slice 1: the
   phases of ``step_dyn_split_rk2`` and the barotropic subcycle inside
   btstep; slice 2: the dynamics, thickness diffusion, MLE, tracer
   advection, tracer_hordiff, the diabatic driver and the ALE
   regrid/remap of ``step_ocean``, and inside them btstep, the K3m
   march, KPP and the continuity kernels). Each device kernel is charged
   to the innermost range whose host range issued its launch, which
   gives per phase: host milliseconds (the range on the host clock,
   profiler on, inclusive of the ranges inside it), device milliseconds
   (its own kernels' durations) and kernel count; and for the step:
   device busy time and idle share (host clock, profiler on, which
   inflates host time).

Prints the tables and, last, one JSON line; with ``--out`` the
profiler's chrome traces are kept there.  A profiler that records no
device activity is reported as such.
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
from mom6_torch.core import barotropic_cuda
from mom6_torch.core import dynamics_split_rk2 as dyn
from mom6_torch.core import orchestrator as orch
from mom6_torch.param.vertical import diabatic as dia
from mom6_torch.parallel.domain import Domain

# (module, function, range name): the functions wrapped in a range
SLICE1 = tuple((dyn, n, n) for n in (
    "pressure_force", "coriolis_adv", "horizontal_viscosity",
    "set_viscous_bbl", "vertvisc_coef", "vertvisc", "vertvisc_remnant",
    "vertvisc_limit_vel", "set_up_bt_cont_cuda", "btstep",
    "continuity_ppm_cuda")) + (
    (barotropic_cuda, "subcycle_cuda", "btstep/subcycle_cuda"),
    (Domain, "fill_halos_group", "fill_halos_group"))
SLICE2 = (
    (orch, "step_dyn_split_rk2", "dynamics"),
    (dyn, "btstep", "dynamics/btstep"),
    (barotropic_cuda, "subcycle_march_cuda",
     "dynamics/btstep/subcycle_march_cuda"),
    (dyn, "continuity_ppm_cuda", "dynamics/continuity_ppm_cuda"),
    (dyn, "set_up_bt_cont_cuda", "dynamics/set_up_bt_cont_cuda"),
    (orch, "thickness_diffuse", "thickness_diffuse"),
    (orch, "mixed_layer_restrat", "mixed_layer_restrat"),
    (orch, "advect_tracers", "advect_tracers"),
    (orch, "tracer_hordiff", "tracer_hordiff"),
    (orch, "diabatic", "diabatic"),
    (dia, "kpp_coefficients", "diabatic/kpp_coefficients"),
    (orch, "ale_regrid_remap", "ale"))
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


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--full", action="store_true",
                   help="profile slice 2, the full ocean step")
    p.add_argument("--layered", action="store_true",
                   help="with --full: the layered variant (no ALE)")
    p.add_argument("--ni", type=int, default=512)
    p.add_argument("--nj", type=int, default=512)
    p.add_argument("--nk", type=int, default=25)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_step: needs a CUDA card")
    cuda_build.build()
    if a.full:
        m = entry.build_full(a.ni, a.nj, a.nk, regridding=not a.layered,
                             device="cuda", dtype=torch.float32)
        full_step = m.step_fn()
        cur = [m.state, m.split, m.tracers]
        n_done = [0]

        def step():
            cur[:] = full_step(*cur, n_done[0])
            n_done[0] += 1

        def kind():
            return "thermo" if (n_done[0] + 1) % m.cfg.n_dyn_per_therm \
                == 0 else "dynamics-only"
        targets = SLICE2
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
    label = ("slice 2 (full step, " + ("layered" if a.layered else "ALE")
             + ")") if a.full else "slice 1"
    print(f"{name}: {label} "
          f"{a.nk}x{a.nj}x{a.ni} fp32, {step_ms:.3f} ms/step (CUDA "
          f"events), {wall_ms:.3f} ms/step (host clock), mean of "
          f"{a.steps} steps; "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in by_kind.items()))
    summary = dict(device=name, slice=2 if a.full else 1,
                   ale=a.full and not a.layered,
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
    for _ in set(kinds):
        k = kind()
        summary["profiled"][k] = _profile(step, targets, k, a.out)
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
