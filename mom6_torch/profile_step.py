"""Where the time of one step of the slice goes on a CUDA card.

    python -m mom6_torch.profile_step [--ni 512 --nj 512 --nk 25]
                                     [--steps 10] [--out DIR]

Builds the kernels and runs the slice of ``mom6_torch.entry`` in fp32.
After two warm-up steps it measures:

1. the step time, by CUDA events around ``--steps`` uninstrumented
   steps;
2. one step under ``torch.profiler`` with a ``record_function`` range
   around every top-level phase of ``step_dyn_split_rk2`` (and around
   the barotropic subcycle inside btstep).  Each device kernel is
   charged to the innermost phase whose host range issued its launch,
   which gives per phase: host milliseconds (the range on the host
   clock, profiler on), device milliseconds (its kernels' durations)
   and kernel count; and for the step: device busy time and idle share
   (host clock, profiler on, which inflates host time).

Prints the tables and, last, one JSON line; with ``--out`` the
profiler's chrome trace is kept there.  A profiler that records no
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
from mom6_torch.parallel.domain import Domain

PHASES = ("pressure_force", "coriolis_adv", "horizontal_viscosity",
          "set_viscous_bbl", "vertvisc_coef", "vertvisc", "vertvisc_remnant",
          "vertvisc_limit_vel", "set_up_bt_cont_cuda", "btstep",
          "continuity_ppm_cuda")
SUBCYCLE = "btstep/subcycle_cuda"


def _ranged(name, fn):
    # functools.wraps also copies attributes such as a kernel wrapper's
    # launch counter, which the wrapped code increments
    @functools.wraps(fn)
    def ranged(*args, **kw):
        with torch.profiler.record_function(name):
            return fn(*args, **kw)
    return ranged


def _attribute(trace: dict):
    """{phase: [host_us, device_us, kernels, calls]} from a chrome trace:
    kernels are matched to their launch by correlation id and charged to
    the innermost phase range containing the launch."""
    ev = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    ranges = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in ev
                    if e.get("cat") == "user_annotation"
                    and (e["name"] in PHASES or e["name"] == SUBCYCLE
                         or e["name"] == "fill_halos_group"))
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in ev
                 if e.get("cat") == "cuda_runtime"
                 and "correlation" in e.get("args", {})}
    out = collections.defaultdict(lambda: [0.0, 0.0, 0, 0])
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
    return out, busy


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ni", type=int, default=512)
    p.add_argument("--nj", type=int, default=512)
    p.add_argument("--nk", type=int, default=25)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_step: needs a CUDA card")
    cuda_build.build()
    s = entry.build(a.ni, a.nj, a.nk, device="cuda", dtype=torch.float32)
    cur = [s.state, s.split]

    def step():
        st, sp, _ = dyn.step_dyn_split_rk2(s.domain, s.grid, s.vgrid, *cur,
                                           s.forces, s.dt, s.cfg)
        cur[:] = [st, sp]

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    name = torch.cuda.get_device_name(0)

    # 1. uninstrumented step time
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(a.steps):
        step()
    end.record()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / a.steps
    step_ms = start.elapsed_time(end) / a.steps
    print(f"{name}: {a.nk}x{a.nj}x{a.ni} fp32, {step_ms:.3f} ms/step "
          f"(CUDA events), {wall_ms:.3f} ms/step (host clock), mean of "
          f"{a.steps} steps")

    # 2. one profiled step with a range around every phase
    saved = {n: getattr(dyn, n) for n in PHASES}
    saved_fill = Domain.fill_halos_group
    saved_sub = barotropic_cuda.subcycle_cuda
    for n, fn in saved.items():
        setattr(dyn, n, _ranged(n, fn))
    Domain.fill_halos_group = _ranged("fill_halos_group", saved_fill)
    barotropic_cuda.subcycle_cuda = _ranged(SUBCYCLE, saved_sub)
    from torch.profiler import ProfilerActivity, profile
    try:
        step()            # warm the wrapped path outside the profile
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            prof_ms = (time.perf_counter() - t0) * 1e3
    finally:
        for n, fn in saved.items():
            setattr(dyn, n, fn)
        Domain.fill_halos_group = saved_fill
        barotropic_cuda.subcycle_cuda = saved_sub
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(a.out or tmp, "profile_step_trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    phases, busy_us = _attribute(trace)
    summary = dict(device=name, shape=[a.nk, a.nj, a.ni], step_ms=step_ms,
                   host_ms_per_step=wall_ms, profiled_step_ms=prof_ms,
                   device_busy_ms=busy_us / 1e3)
    if busy_us <= 0.0:
        print("torch.profiler recorded no device activity: busy time and "
              "idle share not measured")
    else:
        summary["idle_share_profiled"] = 1.0 - busy_us / 1e3 / prof_ms
        summary["phases"] = {k: dict(host_ms=v[0] / 1e3,
                                     device_ms=v[1] / 1e3, kernels=v[2],
                                     calls=v[3]) for k, v in phases.items()}
        print(f"profiled step: {prof_ms:.3f} ms (host clock, profiler on), "
              f"device busy {busy_us / 1e3:.3f} ms, idle share "
              f"{summary['idle_share_profiled']:.1%}")
        print(f"{'phase':26s} {'calls':>5s} {'host ms':>8s} "
              f"{'device ms':>9s} {'kernels':>7s} {'dev share':>9s}")
        for k, v in sorted(phases.items(), key=lambda kv: -kv[1][1]):
            print(f"{k:26s} {v[3]:5d} {v[0] / 1e3:8.3f} {v[1] / 1e3:9.3f} "
                  f"{v[2]:7d} {v[1] / busy_us:9.1%}")
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
