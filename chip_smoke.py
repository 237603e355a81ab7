#!/usr/bin/env python3
"""Drive the PyTorch port (mom6_torch) on one CUDA card and check it.

Run from the root of a checkout: ``python3 chip_smoke.py``.  Phases, in
order; any failure ends the script with a non-zero exit:

1. device: require a CUDA card; print its name and power limit;
2. build: compile the kernels of mom6_torch/csrc with nvcc (one process
   per source, in parallel) into mom6_torch/_build; print ptxas's
   registers and spills of every K1, K2, K3 and K3m instance;
3. kernels against their plain PyTorch versions on the card, on seeded
   random inputs: K1 (continuity sweep, both orders) and K2 (BT_cont
   fit) at 25x520x520, 25x1096x1448 and the deep column 75x264x264
   (each with its tile plan printed), K3 (barotropic subcycle,
   linear and curve transports) at 25x520x520 and 25x1096x1448, K3m
   (the wide-halo march: periods 2 and 4, walled and reentrant y,
   linear and curve transports) on 512x512 planes widened to a halo of
   3*period, and at period 2 on 1440x1088 planes; fp64 and fp32.
   K3 and K3m (period 2, walled y, both transports) also at 128 and 200
   substeps on the 25x520x520 case. First it prints the band plan of the
   persistent K3/K3m launch at those shapes (blocks, points, rows and
   tiles a block, shared memory a block per dtype);
4. slice 1 (the split RK2 dynamics step) at 64x64x8 in fp64 for 3
   steps, on the card (kernels) against the CPU (plain versions);
5. slice 1 at full width, 512x512x25 fp32: 2 warm-up steps, then 10
   timed steps with every launch counter zeroed just before and read
   just after (K3's device launches too: one per subcycle);
6. slice 2 (the full ocean step of bench.py's CONFIG with the wide-halo
   barotropic march), with Z* ALE (the CONFIG's own) and in its layered
   variant, at 32x32x6 in fp64 for 4 steps from a seeded perturbation
   of its initial state, card against CPU;
7. slice 2 at full width, 512x512x25 fp32, each of the two
   configurations: 2 warm-up steps, then 10 timed steps (5
   thermodynamic, 5 dynamics-only) with every launch counter zeroed
   just before and read just after (K3m's device launches too) and the
   peak of torch.cuda.max_memory_allocated over them; with ALE also the
   ALE regrid/remap alone on the last state (CUDA events) and the
   error of a remap onto the unchanged grid in fp32; then each kernel's
   own time beside its bound and its plain version's time, and the
   device kernels that one K1 sweep, one K2 call and one K3 or K3m
   subcycle launch as torch.profiler traces them, with their device
   time from that trace.

The line before the last is the JSON ``kernels`` record; the last line
is ``{"ok": true, "device": {...}}``.
"""

import functools
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
DEV = "cuda"
MAIN = (512, 512, 25)          # (ni, nj, nk) of the slice
WIDE = (1440, 1088, 25)        # the OM4-class width of the kernel checks
DEEP = (256, 256, 75)          # MOM6's 75-layer depth for K1 and K2
SMALL = (64, 64, 8)            # slice 1 checked against the CPU
SMALL_FULL = (32, 32, 6)       # slice 2 checked against the CPU
FULL_VARIANTS = (("ale", True), ("layered", False))   # slice 2's two
# nstep giving 128 and 200 substeps (the DT_BT_FILTER window included)
MANY_SUBSTEPS = {128: 113, 200: 177}
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
PEAK_OPS_PER_S = {"float32": 67e12, "float64": 34e12}   # non-tensor-core

# Operations per point, counted from the kernel sources (arithmetic,
# comparisons and selects; csrc/ppm.cuh, continuity.cu, barotropic.cu):
# the PPM edge values ~100 per cell; one layer's flux and derivative
# with the correction applied, from the upwind cell only, ~35 (both
# upwind branches, as the plain version evaluates them, ~57); the K1
# sweep does 6 Newton passes, the final flux and the divergence (~4) per
# cell-layer; K2 does 3 Newton passes, 3 probes and the probe limits
# (~12) per cell-layer and direction; a K3 or K3m substep with curve
# transports ~162 per point.
OPS_EDGES, OPS_FLUX = 100, 35
OPS_K1 = OPS_EDGES + 7 * OPS_FLUX + 4
OPS_K2 = 2 * (OPS_EDGES + 6 * OPS_FLUX + 12)
OPS_K3_SUBSTEP = 162

KERNELS = {
    "K1": dict(name="continuity_sweep", route="cuda",
               source="mom6_torch/csrc/continuity.cu",
               replaces="mom6_tpu/core/continuity_pallas.py:193"),
    "K2": dict(name="bt_cont_fit", route="cuda",
               source="mom6_torch/csrc/continuity.cu",
               replaces="mom6_tpu/core/continuity_pallas.py:377"),
    "K3": dict(name="barotropic_subcycle", route="cuda",
               source="mom6_torch/csrc/barotropic.cu",
               replaces="mom6_tpu/core/barotropic_pallas.py:164"),
    "K3m": dict(name="barotropic_march", route="cuda",
                source="mom6_torch/csrc/barotropic.cu",
                replaces="mom6_tpu/core/barotropic_pallas.py:232"),
}
DEVICE_COUNTED = ("K3", "K3m")   # wrappers that count device launches
# each kernel's device-kernel name and its wrapper's launches a call
PROFILED = {"K1": ("sweep_kernel", 2), "K2": ("bt_cont_kernel", 1),
            "K3": ("subcycle_kernel", 1), "K3m": ("subcycle_kernel", 1)}
PROFILE_REPS = 5
TOL = {  # relative to each field's max on the compute domain
    "K1": {"float64": 1e-12, "float32": 1e-5},
    "K2": {"float64": 1e-12, "float32": 1e-3},
    # u_turn divides by the near-cancelling FA_far - FA_0, so summation
    # order noise is magnified (fp32 additionally has no degenerate-fit
    # guard that ever fires at |denom| <= 1e-12 |FA_0|)
    "K2_turn": {"float64": 1e-8, "float32": 2e-2},
    "K3": {"float64": 1e-10, "float32": 5e-5},
    "K3m": {"float64": 1e-10, "float32": 5e-5},
}


def log(msg):
    print(msg, flush=True)


def rel_err(ref, out, H=4):
    a = ref[..., H:-H, H:-H].double()
    b = out[..., H:-H, H:-H].double()
    scale = float(a.abs().max())
    diff = float((a - b).abs().max())
    return diff / scale if scale > 0 else diff, diff


def cuda_ms(fn, reps, warm=True):
    """Mean milliseconds of ``fn`` over ``reps`` calls, by CUDA events
    on the current stream."""
    import torch
    if warm:
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


class Results:
    def __init__(self):
        self.err = {k: {} for k in KERNELS}      # dtype -> (rel, abs)

    def check(self, kernel, dtype, label, ref, out, tol_key=None, H=4):
        rel, diff = rel_err(ref, out, H)
        tol = TOL[tol_key or kernel][dtype]
        log(f"  {kernel} {label} {dtype}: max rel err {rel:.3e} "
            f"(limit {tol:.0e}), max abs err {diff:.3e}")
        if not rel <= tol:
            raise AssertionError(f"{kernel} {label} {dtype}: {rel:.3e} > "
                                 f"{tol:.0e}")
        old = self.err[kernel].get(dtype, (0.0, 0.0))
        self.err[kernel][dtype] = (max(old[0], rel), max(old[1], diff))

    def check_all(self, kernel, dtype, label, ref: dict, out: dict, H=4):
        """Every field of ``ref`` against ``out``, logged as one line
        naming the worst field."""
        tol = TOL[kernel][dtype]
        errs = {k: rel_err(ref[k], out[k], H) for k in ref}
        worst = max(errs, key=lambda k: errs[k][0])
        rel, diff = errs[worst]
        log(f"  {kernel} {label} {dtype}: {len(errs)} fields, max rel err "
            f"{rel:.3e} ({worst}; limit {tol:.0e}), max abs err "
            f"{max(e[1] for e in errs.values()):.3e}")
        if not rel <= tol:
            raise AssertionError(f"{kernel} {label} {worst} {dtype}: "
                                 f"{rel:.3e} > {tol:.0e}")
        old = self.err[kernel].get(dtype, (0.0, 0.0))
        self.err[kernel][dtype] = (
            max(old[0], rel), max(old[1], *(e[1] for e in errs.values())))


def make_grid(ni, nj, nk, dtype, device=None, reentrant_y=False):
    from mom6_torch.core.grid import cartesian_grid
    from mom6_torch.core.vertical_grid import VerticalGrid
    from mom6_torch.parallel.domain import Domain
    device = device or DEV
    d = Domain(ni=ni, nj=nj, halo=4, reentrant_x=True,
               reentrant_y=reentrant_y)
    g = cartesian_grid(d, lenlon_km=ni * 10.0, lenlat_km=nj * 10.0,
                       f0=1e-4, beta=2e-11, max_depth=4000.0,
                       device=device, dtype=dtype)
    vg = VerticalGrid.uniform(nk=nk, gint=0.005, device=device,
                              dtype=dtype)
    return d, g, vg


def continuity_inputs(ni, nj, nk, dtype, seed):
    """Random layered state in the style of the JAX package's continuity
    tests: h ~ 160 +- 16 m, u/v ~ 0.3 m/s, visc_rem in [0.5, 1], and
    barotropic transports within 10% of the layer sum."""
    import numpy as np
    import torch
    d, g, vg = make_grid(ni, nj, nk, dtype)
    rng = np.random.default_rng(seed)
    shape = (nk, d.njh, d.nih)

    def t(a):
        return d.fill_halos(torch.as_tensor(a, dtype=dtype, device=DEV))

    h = t(160.0 + 16.0 * rng.standard_normal(shape))
    u = t(0.3 * rng.standard_normal(shape)) * g.mask2dCu
    v = t(0.3 * rng.standard_normal(shape)) * g.mask2dCv
    vr_u = t(rng.uniform(0.5, 1.0, shape))
    vr_v = t(rng.uniform(0.5, 1.0, shape))
    noise = t(rng.uniform(0.9, 1.1, shape[1:]))
    uhbt = torch.sum(u * h, 0) * g.dyCu * noise
    vhbt = torch.sum(v * h, 0) * g.dxCv * noise
    return d, g, vg, dict(u=u, v=v, h=h, vr_u=vr_u, vr_v=vr_v, uhbt=uhbt,
                          vhbt=vhbt)


def log_tile_plans(h):
    """K1's and K2's tile plans for ``h``'s shape and dtype."""
    from mom6_torch.core import continuity_cuda as cc

    def fmt(p):
        return (f"{'xy'[p.axis]} {p.faces} faces x {p.across} across, "
                f"{p.layers} layers x {p.chunks} chunk"
                f"{'s' if p.chunks > 1 else ''}, {p.blocks} blocks, "
                f"{p.smem_bytes} B")
    nk, nj, ni = h.shape
    log(f"  K1/K2 tile plan {nk}x{nj}x{ni} {str(h.dtype)[6:]}: K1 "
        + "; ".join(fmt(cc.launch_plan(h, (a,))[0]) for a in (0, 1))
        + f"; K2 {cc.launch_plan(h, (0, 1))[0].threads} threads: "
        + "; ".join(fmt(p) for p in cc.launch_plan(h, (0, 1))))


def check_k1_k2(res, ni, nj, nk, dtype, timing=None):
    from mom6_torch.core import continuity_cuda as cc
    from mom6_torch.core.continuity_ppm import (ContinuityCfg,
                                                continuity_ppm,
                                                set_up_bt_cont)
    d, g, vg, x = continuity_inputs(ni, nj, nk, dtype, seed=1)
    cfg = ContinuityCfg()
    dt = 600.0
    dn = str(dtype).split(".")[-1]
    shape = f"{nk}x{d.njh}x{d.nih}"
    if x["h"].is_cuda:             # a CPU rehearsal has no card to plan for
        log_tile_plans(x["h"])
    for x_first in (True, False):
        args = (g, vg, x["u"], x["v"], x["h"], dt, cfg)
        kw = dict(uhbt=x["uhbt"], vhbt=x["vhbt"], visc_rem_u=x["vr_u"],
                  visc_rem_v=x["vr_v"], x_first=x_first)
        ref = continuity_ppm(*args, **kw)
        out = cc.continuity_ppm_cuda(*args, x["uhbt"], x["vhbt"],
                                     x["vr_u"], x["vr_v"], x_first=x_first)
        for name in ("h", "uh", "vh", "u_cor", "v_cor"):
            res.check("K1", dn, f"{shape} x_first={x_first} {name}",
                      getattr(ref, name), getattr(out, name))
        if timing is not None and x_first:
            def call():
                cc.continuity_ppm_cuda(*args, x["uhbt"], x["vhbt"],
                                       x["vr_u"], x["vr_v"])
            timing["K1"] = (
                cuda_ms(call, 20) / 2,
                cuda_ms(lambda: continuity_ppm(*args, **kw), 3) / 2,
                call)
    bargs = (g, vg, x["u"], x["v"], x["h"], dt, cfg, x["vr_u"], x["vr_v"])
    ref = set_up_bt_cont(*bargs)
    out = cc.set_up_bt_cont_cuda(*bargs)
    for name in ref._fields:
        turn = name.startswith(("uBT", "vBT"))
        res.check("K2", dn, f"{shape} {name}", getattr(ref, name),
                  getattr(out, name), "K2_turn" if turn else None)
    if timing is not None:
        timing["K2"] = (cuda_ms(lambda: cc.set_up_bt_cont_cuda(*bargs), 20),
                        cuda_ms(lambda: set_up_bt_cont(*bargs), 3),
                        lambda: cc.set_up_bt_cont_cuda(*bargs))


def subcycle_case(ni, nj, nk, dtype, curve, seed=5, reentrant_y=False,
                  period=1, nstep=None):
    """btstep's set-up on random inputs (as in the JAX package's
    subcycle tests), returning the subcycle's inputs: on the model's
    domain for ``period`` 1 (K3), widened to a halo of 3*period for the
    march (K3m)."""
    import numpy as np
    import torch
    from mom6_torch.core.barotropic import (BarotropicCfg, set_dtbt,
                                            subcycle_inputs)
    from mom6_torch.core.continuity_ppm import set_up_bt_cont
    d, g, vg = make_grid(ni, nj, nk, dtype, reentrant_y=reentrant_y)
    rng = np.random.default_rng(seed)

    def t(a):
        return d.fill_halos(d.pad(torch.as_tensor(a, dtype=dtype,
                                                  device=DEV)))

    h = t(rng.uniform(150.0, 170.0, (nk, nj, ni)))
    u = t(0.05 * rng.standard_normal((nk, nj, ni)))
    v = t(0.05 * rng.standard_normal((nk, nj, ni)))
    eta = t(0.05 * rng.standard_normal((nj, ni)))
    acc = t(1e-6 * rng.standard_normal((nk, nj, ni)))
    ecor = t(0.01 * rng.standard_normal((nj, ni)))
    pbce = torch.full_like(h, 9.8 / nk)
    nstep = nstep or set_dtbt(d, g, vg, BarotropicCfg(), 600.0)
    bc = uh0 = vh0 = None
    if curve:
        bc = set_up_bt_cont(g, vg, u, v, h, 600.0)
        uh0 = torch.sum(h * 0.01, 0)
        vh0 = torch.sum(h * 0.005, 0)
    cfg = BarotropicCfg(nstep=nstep, use_bt_cont=curve,
                        wide_halo_period=period)
    return subcycle_inputs(d, g, vg, u, v, eta, h, acc, acc, pbce, u, v,
                           600.0, cfg, taux=0.1 * g.mask2dCu, bt_cont=bc,
                           eta_cor=ecor, uhbt_in=uh0, vhbt_in=vh0)


def check_k3(res, ni, nj, nk, dtype, timing=None, key="K3"):
    """K3 against its plain version, linear and curve transports; the
    curve case timed into ``timing[key]``."""
    from mom6_torch.core import barotropic_cuda as bc
    dn = str(dtype).split(".")[-1]
    for curve in (False, True):
        inp = subcycle_case(ni, nj, nk, dtype, curve)
        args = inp[:-1]          # K3 takes no exchange period
        d = inp.domain
        _, _, _, ref = bc.subcycle_plain(*args)
        _, _, _, out = bc.subcycle_cuda(*args)
        form = "curve" if curve else "linear"
        res.check_all("K3", dn, f"{nk}x{d.njh}x{d.nih} {form}", ref, out)
        if timing is not None and curve:
            timing[key] = (cuda_ms(lambda: bc.subcycle_cuda(*args), 10),
                           cuda_ms(lambda: bc.subcycle_plain(*args), 2),
                           inp)


def check_k3m(res, ni, nj, nk, dtype, timing=None, periods=(2, 4),
              walls=(False, True)):
    """K3m against its plain version, on the whole widened array's
    compute domain; timed at the main path's case (period 2, walled y,
    curve transports)."""
    from mom6_torch.core import barotropic_cuda as bc
    dn = str(dtype).split(".")[-1]
    for period in periods:
        for reentrant_y in walls:
            for curve in (False, True):
                inp = subcycle_case(ni, nj, nk, dtype, curve,
                                    reentrant_y=reentrant_y, period=period)
                _, _, _, ref = bc.subcycle_march_plain(*inp)
                _, _, _, out = bc.subcycle_march_cuda(*inp)
                d = inp.domain
                label = (f"{d.njh}x{d.nih} period {period} "
                         f"{'reentrant' if reentrant_y else 'walled'} y "
                         f"{'curve' if curve else 'linear'}")
                res.check_all("K3m", dn, label, ref, out, H=d.halo)
                if (timing is not None and period == 2 and curve
                        and not reentrant_y):
                    timing["K3m"] = (
                        cuda_ms(lambda: bc.subcycle_march_cuda(*inp), 10),
                        cuda_ms(lambda: bc.subcycle_march_plain(*inp), 2),
                        inp)


def check_k3_many(res, ni, nj, nk, dtype):
    """K3 and K3m (period 2, walled y) against their plain versions at
    each substep count of MANY_SUBSTEPS, linear and curve transports."""
    from mom6_torch.core import barotropic_cuda as bc
    dn = str(dtype).split(".")[-1]
    kernels = (("K3", 1, bc.subcycle_plain, bc.subcycle_cuda),
               ("K3m", 2, bc.subcycle_march_plain, bc.subcycle_march_cuda))
    for total, nstep in MANY_SUBSTEPS.items():
        for curve in (False, True):
            form = "curve" if curve else "linear"
            for key, period, plain, kern in kernels:
                inp = subcycle_case(ni, nj, nk, dtype, curve, period=period,
                                    nstep=nstep)
                if inp.wts.shape[1] != total:
                    raise AssertionError(f"nstep {nstep} gives "
                                         f"{inp.wts.shape[1]} substeps, "
                                         f"expected {total}")
                args = inp[:-1] if period == 1 else inp   # K3: no period
                _, _, _, ref = plain(*args)
                _, _, _, out = kern(*args)
                d = inp.domain
                res.check_all(key, dn, f"{d.njh}x{d.nih} {total} substeps "
                              f"{form}", ref, out, H=d.halo)


def log_band_plans():
    """The persistent K3/K3m launch's band plan at the shapes phase 3
    runs: K3 on the model's planes, K3m on planes widened to a halo of
    3*period."""
    import torch
    from mom6_torch.core import barotropic_cuda as bc
    sms, smem = bc.device_limits(torch.cuda.current_device())
    log(f"  K3/K3m band plan: {sms} SMs, {smem} B of shared memory a "
        f"block, {bc.THREADS} threads a block, tiles of "
        f"{bc.THREADS * bc.POINTS_PER_THREAD} points")
    for label, (ni, nj, _), pad in (
            ("K3", MAIN, 0), ("K3m period 2", MAIN, 2),
            ("K3m period 4", MAIN, 8), ("K3", WIDE, 0),
            ("K3m period 2", WIDE, 2)):
        ni, nj = ni + 8 + 2 * pad, nj + 8 + 2 * pad
        cells = []
        for dn, item in (("fp32", 4), ("fp64", 8)):
            for curve in (True, False):
                p = bc.band_plan(nj, ni, item, curve, sms, smem)
                cells.append(
                    f"{dn} {'curve' if curve else 'linear'} {p.blocks} "
                    f"blocks x {p.points_per_block} points "
                    f"({p.points_per_block / ni:.2f} rows, {p.tiles} "
                    f"tile{'s' if p.tiles > 1 else ''}), {p.smem_bytes} B "
                    f"shared ({p.placement})")
        log(f"  {label} {nj}x{ni}: " + "; ".join(cells))


def log_resources(ptxas_log, kernel):
    """ptxas's registers, stack and spills of each instance of
    ``kernel`` (empty when the library was already built)."""
    current = None
    for line in ptxas_log.splitlines():
        if "Function properties for" in line:
            current = line.split("for", 1)[1].strip()
        elif current and kernel in current and (
                "spill" in line or "Used" in line):
            log(f"  ptxas {current}: {line.split(':', 1)[-1].strip()}")


def bc_plan(inp):
    """A short description of the band plan of ``inp``'s subcycle."""
    from mom6_torch.core import barotropic_cuda as bc
    p = bc.launch_plan(inp.eta, inp.use_curve)
    return (f"{p.blocks} blocks x {p.points_per_block} points, {p.tiles} "
            f"tile{'s' if p.tiles > 1 else ''}, {p.placement} transport "
            "constants")


def profiled_kernels(fn, kernel, reps=1):
    """The device kernels ``reps`` calls of ``fn`` launch, as
    torch.profiler traces them: (those whose name holds ``kernel``, all,
    mean device milliseconds a call of the ``kernel`` ones)."""
    import os
    import tempfile
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    kern = [e for e in events
            if e.get("ph") == "X" and e.get("cat") == "kernel"]
    mine = [e["dur"] for e in kern if kernel in e["name"]]
    return len(mine), len(kern), sum(mine) / 1e3 / reps


def subcycle_work(inp):
    """(elements moved, operations) of one K3/K3m subcycle: eta, ubt,
    vbt, the constant planes and the weights in, 7 sums and 3 planes
    out, on the arrays the kernel runs on (widened for K3m)."""
    total = inp.wts.shape[1]
    nconst = 20 + (22 if inp.use_curve else 0)
    p = inp.eta.numel()
    return (3 + nconst + 10) * p + 4 * total, OPS_K3_SUBSTEP * total * p


def bound(elems, ops, item, dtn):
    """(bound_ms, bound_by): the larger of ``elems`` elements of
    ``item`` bytes over HBM bandwidth and ``ops`` over the fp peak."""
    t_bytes = elems * item / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtn] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bounds(timing, nk, njh, nih, item, dtn):
    """(bound_ms, bound_by) for each kernel at the main path's shape:
    the larger of the bytes each input read once and each output
    written once over HBM bandwidth, and the operations over the fp
    peak."""
    P = njh * nih
    work = {
        # u, h, visc_rem, hbt + 6 grid planes in; h, flux, u_cor out
        "K1": ((6 * nk) * P + 7 * P, OPS_K1 * nk * P),
        # u, v, h, 2 visc_rem + 9 grid planes in; 12 planes out
        "K2": ((5 * nk) * P + 21 * P, OPS_K2 * nk * P),
        "K3": subcycle_work(timing["K3"][2]),
        "K3m": subcycle_work(timing["K3m"][2]),
    }
    return {k: bound(*w, item, dtn) for k, w in work.items()}


def check_device_launches(label, device, launches):
    """K3 and K3m issue one device launch per subcycle."""
    for k, n in device.items():
        if n != launches[k]:
            raise AssertionError(f"{label}: {k} issued {n} device launches "
                                 f"for {launches[k]} subcycles, expected "
                                 "one each")
    log(f"  {label} device launches {device}")


def run_slice(ni, nj, nk, dtype, device, nsteps):
    from mom6_torch import entry
    from mom6_torch.core.dynamics_split_rk2 import step_dyn_split_rk2
    s = entry.build(ni, nj, nk, device=device, dtype=dtype)
    st, sp = s.state, s.split
    for _ in range(nsteps):
        st, sp, _ = step_dyn_split_rk2(s.domain, s.grid, s.vgrid, st, sp,
                                       s.forces, s.dt, s.cfg)
    return s, st, sp


def run_full(ni, nj, nk, dtype, device, nsteps, seed, regridding):
    """``nsteps`` full steps from the configuration's initial state plus
    the seeded perturbation of ``entry.build_full``: the configuration
    starts at rest and horizontally uniform, where a comparison of the
    first steps' v and eta would compare roundoff."""
    from mom6_torch import entry
    m = entry.build_full(ni, nj, nk, seed=seed, regridding=regridding,
                         device=device, dtype=dtype)
    step = m.step_fn()
    st, sp, tr = m.state, m.split, m.tracers
    for n in range(nsteps):
        st, sp, tr = step(st, sp, tr, n)
    return st, sp, tr


def run_full_timed(label, regridding, nsteps, wrappers, shape):
    """Slice 2 at full width in fp32: 2 warm-up steps, then ``nsteps``
    timed steps with every launch counter zeroed just before and read
    just after, and the peak of max_memory_allocated over them.  With
    ALE also the ALE call alone on the last state and the error of a
    remap onto the unchanged grid."""
    import torch
    from mom6_torch import entry
    m = entry.build_full(*MAIN, regridding=regridding, device=DEV,
                         dtype=torch.float32)
    full_step = m.step_fn()
    cur = [m.state, m.split, m.tracers]
    n_done = [0]

    def fstep():
        cur[:] = full_step(*cur, n_done[0])
        n_done[0] += 1

    for _ in range(2):
        fstep()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for w in wrappers.values():
        w.launches = 0
    for k in DEVICE_COUNTED:
        wrappers[k].device_launches = 0
    events = [torch.cuda.Event(enable_timing=True)
              for _ in range(nsteps + 1)]
    kinds = []
    t0 = time.perf_counter()
    events[0].record()
    for i in range(nsteps):
        kinds.append("thermo" if (n_done[0] + 1) % m.cfg.n_dyn_per_therm
                     == 0 else "dynamics-only")
        fstep()
        events[i + 1].record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    device = {k: wrappers[k].device_launches for k in DEVICE_COUNTED}
    peak = torch.cuda.max_memory_allocated()
    st, sp, tr = cur
    check_finite((("h", st.h), ("u", st.u), ("v", st.v), ("T", st.T),
                  ("S", st.S), ("age", tr["age"]), ("eta", sp.eta),
                  ("u_av", sp.u_av), ("uh", sp.uh)), shape)
    expect = {"K1": 4 * nsteps, "K2": nsteps, "K3": 0, "K3m": 2 * nsteps}
    if launches != expect:
        raise AssertionError(f"slice 2 ({label}) launch counts {launches}, "
                             f"expected {expect}")
    check_device_launches(f"slice 2 ({label})", device, launches)
    per = [events[i].elapsed_time(events[i + 1]) for i in range(nsteps)]
    by_kind = {k: [t for t, kk in zip(per, kinds) if kk == k]
               for k in ("thermo", "dynamics-only")}
    ms_full = sum(per) / nsteps
    pts = MAIN[0] * MAIN[1] * MAIN[2] / (ms_full / 1e3)
    log(f"  {nsteps} steps: {ms_full:.3f} ms/step mean (CUDA events), "
        + ", ".join(f"{k} {sum(v) / len(v):.3f} ms/step over {len(v)}"
                    for k, v in by_kind.items())
        + f"; {wall / nsteps * 1e3:.3f} ms/step (host clock), "
        f"{pts:.4e} points/s, launches {launches}, peak memory "
        f"{peak} B ({peak / 2**30:.3f} GiB, max_memory_allocated)")
    log(f"  h range [{float(m.domain.interior(st.h).min()):.3f}, "
        f"{float(m.domain.interior(st.h).max()):.3f}] m, "
        f"T range [{float(m.domain.interior(st.T).min()):.3f}, "
        f"{float(m.domain.interior(st.T).max()):.3f}] degC, "
        f"max |u| {float(st.u.abs().max()):.4f} m/s, "
        f"max |eta| {float(sp.eta.abs().max()):.4f} m, "
        f"max age {float(tr['age'].max()):.3e} yr")
    if regridding:
        check_ale(m, st, sp, tr)
    return dict(ms_step=ms_full, launches=launches, device=device,
                peak_bytes=peak, state=st)


def check_ale(m, st, sp, tr):
    """The ALE regrid/remap alone on the full step's last state (CUDA
    events, and its peak memory above what was allocated), and the
    remap of T and u onto the unchanged grid, whose exact answer is the
    field itself (on the compute domain: a column of zero thickness, as
    in the halo rows beyond a wall, remaps to NaN in float32)."""
    import torch
    from mom6_torch.ale.ale_main import ale_regrid_remap
    from mom6_torch.ale.remapping import remap_column_means
    aux_u = {"u_av": sp.u_av, "diffu": sp.diffu}
    aux_v = {"v_av": sp.v_av, "diffv": sp.diffv}

    def call():
        return ale_regrid_remap(m.grid, m.vgrid, st, m.cfg.ale, eos=m.eos,
                                tracers=tr, aux_u=aux_u, aux_v=aux_v,
                                dt=m.dt_therm)

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(call, 5)
    extra = torch.cuda.max_memory_allocated() - base
    log(f"  ALE regrid/remap alone: {ms:.3f} ms a call (CUDA events, 5 "
        f"calls), {extra} B ({extra / 2**30:.3f} GiB) above the state at "
        "its peak")
    hu = 0.5 * (st.h + torch.roll(st.h, -1, -1))
    for name, h, f in (("T", st.h, st.T), ("u", hu, st.u)):
        out = remap_column_means(h, f, h, m.cfg.ale.remap)
        rel, diff = rel_err(f, out)
        log(f"  remap onto the unchanged grid, fp32 {name}: max abs err "
            f"{diff:.3e}, max rel err {rel:.3e}")
        if not bool(torch.isfinite(m.domain.interior(out)).all()):
            raise AssertionError(f"no-motion remap of {name} not finite")


def check_finite(fields, shape):
    import torch
    for name, f in fields:
        if f.shape[-2:] != shape[1:] or (f.dim() == 3 and f.shape != shape):
            raise AssertionError(f"field {name} has shape "
                                 f"{tuple(f.shape)}, expected {shape}")
        if not bool(torch.isfinite(f).all()):
            raise AssertionError(f"field {name} is not finite")


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script runs on a CUDA card only")
    if not (ROOT / "mom6_torch" / "csrc").is_dir():
        raise SystemExit("chip_smoke: run from the root of a checkout "
                         "(mom6_torch/ not found beside this script)")
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # 1. device
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"phase 1 device: {kind}, count {torch.cuda.device_count()}")

    # 2. build
    from mom6_torch import cuda_build
    t0 = time.perf_counter()
    logs = cuda_build.build()
    log(f"phase 2 build: {time.perf_counter() - t0:.1f} s "
        f"({', '.join(cuda_build.SOURCES)})")
    log_resources(logs.get("continuity", ""), "sweep_kernel")
    log_resources(logs.get("continuity", ""), "bt_cont_kernel")
    log_resources(logs.get("barotropic", ""), "subcycle_kernel")
    log_band_plans()

    # 3. kernels against their plain versions
    log("phase 3 kernels vs plain")
    res = Results()
    timing = {}
    for dtype in (torch.float64, torch.float32):
        main_shape = dtype == torch.float32
        check_k1_k2(res, *MAIN, dtype, timing if main_shape else None)
        check_k3(res, *MAIN, dtype, timing if main_shape else None)
        check_k3m(res, *MAIN, dtype, timing if main_shape else None)
        check_k3_many(res, *MAIN, dtype)
        check_k1_k2(res, *WIDE, dtype)
        check_k3(res, *WIDE, dtype, timing if main_shape else None,
                 key="K3 wide")
        check_k3m(res, *WIDE, dtype, periods=(2,), walls=(False,))
        check_k1_k2(res, *DEEP, dtype)
        torch.cuda.empty_cache()
    ms, plain_ms, inp = timing.pop("K3 wide")
    b_ms, b_by = bound(*subcycle_work(inp), 4, "float32")
    log(f"  K3 at {inp.eta.shape[0]}x{inp.eta.shape[1]} fp32 curve "
        f"({bc_plan(inp)}, {inp.wts.shape[1]} substeps): {ms:.4f} ms per "
        f"subcycle, bound {b_ms:.4f} ms ({b_by}), plain {plain_ms:.4f} ms")
    del inp

    # 4. slice 1 at 64x64x8 fp64: card against CPU
    log("phase 4 slice 1 %dx%dx%d fp64, 3 steps: card vs cpu" % SMALL)
    _, gst, gsp = run_slice(*SMALL, torch.float64, DEV, 3)
    _, cst, csp = run_slice(*SMALL, torch.float64, "cpu", 3)
    for name, a, b in (("h", cst.h, gst.h), ("u", cst.u, gst.u),
                       ("v", cst.v, gst.v), ("eta", csp.eta, gsp.eta)):
        rel, diff = rel_err(a, b.cpu())
        log(f"  slice 1 {name}: max rel err {rel:.3e} (limit 1e-09)")
        if not rel <= 1e-9:
            raise AssertionError(f"slice 1 {name}: {rel:.3e} > 1e-9")

    from mom6_torch import entry
    from mom6_torch.core import barotropic_cuda, continuity_cuda
    from mom6_torch.core.dynamics_split_rk2 import step_dyn_split_rk2
    wrappers = {"K1": continuity_cuda.continuity_ppm_cuda,
                "K2": continuity_cuda.set_up_bt_cont_cuda,
                "K3": barotropic_cuda.subcycle_cuda,
                "K3m": barotropic_cuda.subcycle_march_cuda}

    # 5. slice 1 at full width, fp32
    log("phase 5 slice 1 %dx%dx%d fp32" % MAIN)
    s = entry.build(*MAIN, device=DEV, dtype=torch.float32)
    cur = [s.state, s.split]

    def step():
        st, sp, _ = step_dyn_split_rk2(s.domain, s.grid, s.vgrid, *cur,
                                       s.forces, s.dt, s.cfg)
        cur[:] = [st, sp]

    for _ in range(2):
        step()
    nsteps = 10
    for w in wrappers.values():
        w.launches = 0
    for k in DEVICE_COUNTED:
        wrappers[k].device_launches = 0
    t0 = time.perf_counter()
    ms_step = cuda_ms(step, nsteps, warm=False)
    wall = time.perf_counter() - t0
    launches_s1 = {k: w.launches for k, w in wrappers.items()}
    device_s1 = {k: wrappers[k].device_launches for k in DEVICE_COUNTED}
    st, sp = cur
    shape = (MAIN[2], MAIN[1] + 8, MAIN[0] + 8)
    check_finite((("h", st.h), ("u", st.u), ("v", st.v), ("eta", sp.eta),
                  ("u_av", sp.u_av), ("uh", sp.uh)), shape)
    expect = {"K1": 4 * nsteps, "K2": nsteps, "K3": 2 * nsteps, "K3m": 0}
    if launches_s1 != expect:
        raise AssertionError(f"slice 1 launch counts {launches_s1}, "
                             f"expected {expect}")
    check_device_launches("slice 1", device_s1, launches_s1)
    pts = MAIN[0] * MAIN[1] * MAIN[2] / (ms_step / 1e3)
    log(f"  {nsteps} steps: {ms_step:.3f} ms/step (CUDA events), "
        f"{wall / nsteps * 1e3:.3f} ms/step (host clock), "
        f"{pts:.4e} points/s, launches {launches_s1}")
    log(f"  h range [{float(s.domain.interior(st.h).min()):.3f}, "
        f"{float(s.domain.interior(st.h).max()):.3f}] m, "
        f"max |u| {float(st.u.abs().max()):.4f} m/s, "
        f"max |eta| {float(sp.eta.abs().max()):.4f} m")
    del s, cur, st, sp
    torch.cuda.empty_cache()

    # 6. slice 2 at 32x32x6 fp64: card against CPU, with ALE and layered
    for label, regridding in FULL_VARIANTS:
        log(f"phase 6 slice 2 ({label}) %dx%dx%d fp64, 4 steps: card vs "
            "cpu" % SMALL_FULL)
        gst, gsp, gtr = run_full(*SMALL_FULL, torch.float64, DEV, 4, seed=3,
                                 regridding=regridding)
        cst, csp, ctr = run_full(*SMALL_FULL, torch.float64, "cpu", 4,
                                 seed=3, regridding=regridding)
        for name, a, b in (("h", cst.h, gst.h), ("u", cst.u, gst.u),
                           ("v", cst.v, gst.v), ("T", cst.T, gst.T),
                           ("S", cst.S, gst.S),
                           ("age", ctr["age"], gtr["age"]),
                           ("eta", csp.eta, gsp.eta)):
            rel, diff = rel_err(a, b.cpu())
            log(f"  slice 2 ({label}) {name}: max rel err {rel:.3e} "
                "(limit 1e-09)")
            if not rel <= 1e-9:
                raise AssertionError(f"slice 2 ({label}) {name}: "
                                     f"{rel:.3e} > 1e-9")

    # 7. slice 2 at full width, fp32, with ALE and layered
    full = {}
    for label, regridding in FULL_VARIANTS:
        log(f"phase 7 slice 2 ({label}) %dx%dx%d fp32" % MAIN)
        full[label] = run_full_timed(label, regridding, nsteps, wrappers,
                                     shape)
        torch.cuda.empty_cache()
    launches, device, st = (full["ale"][k] for k in ("launches", "device",
                                                     "state"))
    d_ms = {k: v["ms_step"] for k, v in full.items()}
    log(f"  ALE against layered: {d_ms['ale'] - d_ms['layered']:.3f} "
        "ms/step (CUDA events; the counterpart of bench.py's "
        "ale_regrid_remap probe), peak memory "
        + ", ".join(f"{k} {v['peak_bytes'] / 2**30:.3f} GiB"
                    for k, v in full.items()))

    nk, njh, nih = st.h.shape
    bnd = bounds(timing, nk, njh, nih, 4, "float32")
    log(f"  kernel times at {nk}x{njh}x{nih} fp32 (no single PyTorch "
        "call computes any of these functions: library_ms is null)")
    records = []
    units = {"K1": "per sweep", "K2": "per call", "K3": "per subcycle",
             "K3m": "per subcycle"}
    for k, meta in KERNELS.items():
        ms, plain_ms, inp = timing[k]
        b_ms, b_by = bnd[k]
        # each kernel's count on the path it serves: slice 2's full step
        # (with ALE) for K1, K2 and K3m, slice 1's dynamics step for K3
        n_launch = launches_s1[k] if k == "K3" else launches[k]
        # the device kernels of PROFILE_REPS wrapper calls in one trace:
        # one per launch unit, and for K1 and K2 nothing else
        name, per_call = PROFILED[k]
        if callable(inp):
            call = inp
        else:
            wrap = wrappers[k]
            call = functools.partial(wrap, *(inp[:-1] if k == "K3" else inp))
        n_prof, n_all, dev_ms = profiled_kernels(call, name, PROFILE_REPS)
        units_traced = PROFILE_REPS * per_call
        if n_prof != units_traced or (k not in DEVICE_COUNTED
                                      and n_all != n_prof):
            raise AssertionError(f"{k}: torch.profiler traced {n_prof} "
                                 f"{name} kernels ({n_all} device kernels "
                                 f"in all) in {units_traced} launches, "
                                 "expected one each")
        extra = dict(profiled_kernels_per_call=n_prof / units_traced,
                     profiled_device_ms=dev_ms / per_call)
        log(f"  {k}: torch.profiler traces {n_prof} {name} kernels and "
            f"{n_all} device kernels in all in {units_traced} launches "
            f"({units[k]}), {dev_ms / per_call:.4f} ms of device time "
            f"{units[k]}")
        if k in DEVICE_COUNTED:
            n_dev = device_s1[k] if k == "K3" else device[k]
            extra.update(device_launches=n_dev,
                         device_launches_per_subcycle=n_dev / n_launch,
                         profiled_subcycle_kernels_per_subcycle=(
                             n_prof / units_traced))
            log(f"  {k}: {n_dev} device launches for {n_launch} "
                f"subcycles ({bc_plan(inp)})")
        log(f"  {k} {meta['name']}: {ms:.4f} ms {units[k]} (CUDA events), "
            f"{dev_ms / per_call:.4f} ms (profiler), bound "
            f"{b_ms:.4f} ms ({b_by}), plain {plain_ms:.4f} ms, "
            f"launches {n_launch}")
        records.append(dict(
            meta, launches=n_launch,
            launches_by_path={
                "slice1_dynamics_step": launches_s1[k],
                "slice2_full_step": launches[k],
                "slice2_full_step_layered": full["layered"]["launches"][k]},
            max_abs_err=res.err[k]["float32"][1],
            max_rel_err_fp32=res.err[k]["float32"][0],
            max_rel_err_fp64=res.err[k]["float64"][0],
            ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=None, unit=units[k], **extra))
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
    print(smi, flush=True)
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
