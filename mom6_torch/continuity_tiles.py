"""Where the time of kernels K1 and K2 goes, on a CUDA card.

    python -m mom6_torch.continuity_tiles [--ni 512 --nj 512 --nk 25]

On seeded random continuity inputs in fp32 (those of chip_smoke.py's
kernel checks: h ~ 160 +- 16 m, u/v ~ 0.3 m/s, visc_rem in [0.5, 1])
it times, by CUDA events over 20 calls each:

1. a K1 sweep of each direction at 0, 6 and 12 Newton iterations: the
   cost of one Newton pass, and the fixed cost of the copies, the edge
   values, the final pass and the stores;
2. each tile shape ``tile_plan`` chooses among, for one x and one y
   sweep, and K2 at the best x and y shapes of one block size; every
   result is held bitwise to the default plan's;
3. builds of csrc/continuity.cu with one phase removed (the edge values,
   the copies into shared memory, the stores, or copies and edges),
   timed beside the unchanged source: their results are wrong by
   design, only their times are read.

Prints the card's name and power limit first and one line per
measurement.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import torch

from mom6_torch import cuda_build
from mom6_torch.core import continuity_cuda as cc
from mom6_torch.core.continuity_ppm import ContinuityCfg
from mom6_torch.core.grid import cartesian_grid
from mom6_torch.core.vertical_grid import VerticalGrid
from mom6_torch.parallel.domain import Domain

DT = 600.0
# (name, text in csrc/continuity.cu, its replacement) of each phase
# removed in part 3
ABLATIONS = {
    "edges": [("  T hv[5], mv[5];\n#pragma unroll",
               "  return;\n  T hv[5], mv[5];\n#pragma unroll")],
    "copies": [("__device__ inline void cp_async(T* dst, const T* src) {",
                "__device__ inline void cp_async(T* dst, const T* src) {\n"
                "  return;")],
    "stores": [("    return p >= 1 && a - 1 + p < n && q0 + q < m;",
                "    return false;")],
}
ABLATIONS["copies and edges"] = ABLATIONS["copies"] + ABLATIONS["edges"]


def _inputs(ni, nj, nk, seed=1):
    d = Domain(ni=ni, nj=nj, halo=4, reentrant_x=True)
    g = cartesian_grid(d, lenlon_km=ni * 10.0, lenlat_km=nj * 10.0, f0=1e-4,
                       beta=2e-11, max_depth=4000.0, device="cuda",
                       dtype=torch.float32)
    vg = VerticalGrid.uniform(nk=nk, gint=0.005, device="cuda",
                              dtype=torch.float32)
    rng = np.random.default_rng(seed)
    shape = (nk, d.njh, d.nih)

    def t(a):
        return d.fill_halos(torch.as_tensor(a, dtype=torch.float32,
                                            device="cuda"))

    h = t(160.0 + 16.0 * rng.standard_normal(shape))
    u = t(0.3 * rng.standard_normal(shape)) * g.mask2dCu
    v = t(0.3 * rng.standard_normal(shape)) * g.mask2dCv
    vr_u = t(rng.uniform(0.5, 1.0, shape))
    vr_v = t(rng.uniform(0.5, 1.0, shape))
    noise = t(rng.uniform(0.9, 1.1, shape[1:]))
    return g, vg, dict(h=h, u=u, v=v, vr_u=vr_u, vr_v=vr_v,
                       uhbt=torch.sum(u * h, 0) * g.dyCu * noise,
                       vhbt=torch.sum(v * h, 0) * g.dxCv * noise)


def _ms(fn, reps=20):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _same(ref, out):
    return all(bool(torch.equal(a, b)) for a, b in zip(ref, out))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ni", type=int, default=512)
    p.add_argument("--nj", type=int, default=512)
    p.add_argument("--nk", type=int, default=25)
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("continuity_tiles: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    cuda_build.build(("continuity",))
    g, vg, x = _inputs(a.ni, a.nj, a.nk)
    nk, nj, ni = x["h"].shape
    sms, smem = cc.device_limits(torch.cuda.current_device())
    sweeps = {0: (x["u"], x["vr_u"], x["uhbt"]),
              1: (x["v"], x["vr_v"], x["vhbt"])}

    def sweep(axis, cfg=ContinuityCfg()):
        vel, vr, hbt = sweeps[axis]
        return cc._sweep(g, vg, vel, x["h"], vr, hbt, DT, cfg, axis)

    bargs = (g, vg, x["u"], x["v"], x["h"], DT, ContinuityCfg(), x["vr_u"],
             x["vr_v"])

    # 1. Newton passes against the fixed cost
    for axis in (0, 1):
        for iters in (0, 6, 12):
            cfg = ContinuityCfg(newton_iters=iters)
            print(f"K1 {'xy'[axis]} {nk}x{nj}x{ni} fp32, {iters} Newton "
                  f"iterations: {_ms(lambda: sweep(axis, cfg)):.4f} ms",
                  flush=True)

    # 2. the tile shapes
    default = cc.launch_plan
    timed = {}
    try:
        for axis in (0, 1):
            ref = sweep(axis)
            n, m = (ni, nj) if axis == 0 else (nj, ni)
            for threads in range(32, cc.MAX_THREADS + 1, 32):
                for f, q in cc._shapes(axis, threads):
                    plan = cc._plan(nk, n, m, 4, axis, f, q, smem)
                    if plan is None or plan.chunks > 1:
                        continue
                    cc.launch_plan = lambda h, axes, plan=plan: (plan,)
                    same = _same(ref, sweep(axis))
                    ms = _ms(lambda: sweep(axis))
                    timed.setdefault(threads, {})[axis] = min(
                        timed.get(threads, {}).get(axis, (ms, plan)),
                        (ms, plan), key=lambda t: t[0])
                    print(f"K1 {'xy'[axis]} tile {f} faces x {q} across, "
                          f"{plan.smem_bytes} B: {ms:.4f} ms, model "
                          f"{cc._cost((plan,), sms, smem)[2]:.3f}, "
                          f"{'equal' if same else 'DIFFERS'}", flush=True)
        cc.launch_plan = default
        ref = cc.set_up_bt_cont_cuda(*bargs)
        for threads, best in sorted(timed.items()):
            if len(best) < 2:
                continue
            px, py = best[0][1], best[1][1]
            cc.launch_plan = lambda h, axes, px=px, py=py: (px, py)
            same = _same(ref, cc.set_up_bt_cont_cuda(*bargs))
            print(f"K2 {threads} threads, x {px.faces}x{px.across}, y "
                  f"{py.faces}x{py.across}: "
                  f"{_ms(lambda: cc.set_up_bt_cont_cuda(*bargs)):.4f} ms, "
                  f"{'equal' if same else 'DIFFERS'}", flush=True)
    finally:
        cc.launch_plan = default

    # 3. one phase removed at a time
    src = (cuda_build.CSRC / "continuity.cu").read_text()
    with tempfile.TemporaryDirectory() as tmp:
        builds = {"unchanged": src}
        for name, subs in ABLATIONS.items():
            text = src
            for old, new in subs:
                if text.count(old) != 1:
                    raise RuntimeError(f"ablation {name}: source changed")
                text = text.replace(old, new)
            builds[f"without {name}"] = text
        procs = {}
        for i, (name, text) in enumerate(builds.items()):
            cu = Path(tmp) / f"v{i}.cu"
            cu.write_text(text)
            procs[name] = (Path(tmp) / f"libv{i}.so", subprocess.Popen(
                [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-I",
                 str(cuda_build.CSRC), "-o", str(Path(tmp) / f"libv{i}.so"),
                 str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        for name, (_, proc) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        load = cuda_build.load
        try:
            for name, (lib, _) in procs.items():
                cuda_build.load = lambda _, lib=ctypes.CDLL(str(lib)): lib
                cc._lib.cache_clear()
                print(f"{name}: K1 x {_ms(lambda: sweep(0)):.4f} ms, K1 y "
                      f"{_ms(lambda: sweep(1)):.4f} ms, K2 "
                      f"{_ms(lambda: cc.set_up_bt_cont_cuda(*bargs)):.4f} "
                      "ms", flush=True)
        finally:
            cuda_build.load = load
            cc._lib.cache_clear()


if __name__ == "__main__":
    main()
