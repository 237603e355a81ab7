#!/usr/bin/env python3
"""Drive the PyTorch port (mom6_torch) on one CUDA card and check it.

Run from the root of a checkout: ``python3 chip_smoke.py``.  Phases, in
order; any failure ends the script with a non-zero exit:

1. device: require a CUDA card; print its name and power limit, and the
   versions of Python, PyTorch, CUDA, NumPy and SciPy;
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
   tiles a block, shared memory a block per dtype).  Then the closed
   basin (walls in x): K1, K2 and K3 at cases/double_gyre's 2x48x52 and
   at 25x520x520, fp64 and fp32, each required equal to its plain
   version, with the tile and band plans printed.  Then the K1/K2 modes
   of the RK2b and unsplit steppers and the reference cases, each
   required equal to its plain version at 25x520x520 and on the closed
   basin 2x48x52, fp64 and fp32: K1 untargeted (no barotropic
   transport to match), and K1 (both orders, matched and untargeted)
   and K2 under each of upwind_1st, simple_2nd, monotonic and vol_cfl;
   each mode timed in fp32 at 25x520x520 (CUDA events and the
   profiler) beside its bound and its plain version.  Then porous
   faces: K1 (both orders, matched and untargeted) on a grid with
   ridges on about a fifth of its faces, and K2 on that grid (which
   fits its curves with the plain masks), each required equal to its
   plain version at 25x520x520 and 2x48x52, fp64 and fp32, the porous
   K1 timed in fp32 with the faces' open fractions computed before the
   timed launches (and once more with them, as the wrapper runs); and
   K3 and K3m on planes built under BT_STRONG_DRAG and
   BOUND_BT_CORRECTION, against their plain versions.  Last, open
   boundaries: K3's open-face instance against its plain version,
   required equal, with the segments of configs.BENCH_CONFIG_OBC (whole
   W and E edges, the E data painted per row from obc_east.nc and
   interpolated in time, a strip over the middle half of the S edge) at
   25x520x520 and on the closed-x 2x48x52, fp64 and fp32, timed in fp32
   at 25x520x520; and K1 (both orders) on inputs whose halos are
   extended through those open edges, required equal;
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
   time from that trace (traced at the end of phase 3: a trace taken
   after the long phases loses kernel events);
6b. the split RK2b step (BT_WIDE_HALO_PERIOD 1 and 2) and the unsplit
   RK3 step of bench.py's CONFIG (entry.build_full's ``dynamics``) at
   32x32x6 in fp64, card against CPU: RK2b for 4 steps, unsplit for 6
   (its DT_THERM is 6 DT, so the last is a thermodynamic step with ALE);
7b. the two at full width, 512x512x25 fp32: 2 warm-up steps, then 12
   timed steps with every launch counter zeroed just before and read
   just after (launches a step asserted: RK2b K1 8, 4 of them
   untargeted, K2 1, K3m 2; unsplit K1 6, all untargeted), ms/step by
   kind of step, the peak of max_memory_allocated, finite fields, and
   one device kernel per launch in a torch.profiler trace of 2 steps;
6c. configs.BENCH_CONFIG_B1 (tides with spherical-harmonic SAL, the
   Stanley correction, porous barriers, ZB2020 and Leith viscosity, the
   barotropic and vertical-friction options of the first breadth item)
   and BENCH_CONFIG_NONBOUSS (the non-Boussinesq step) through
   entry.build_full at 32x32x6 in fp64 for 4 steps, card against CPU;
   then B1 in fp32 on the card against fp64, with the tides on and off,
   and bench.py's CONFIG beside it;
6d. open boundaries: configs.BENCH_CONFIG_OBC (entry.build_full's
   "obc": adiabatic, layered, three dyes) at 32x32x6 in fp64 for 4
   steps, and bench.py's CONFIG with the same segments (Z* ALE, T/S and
   the age tracer through the reservoirs) for 2 steps, card against
   CPU;
7d. BENCH_CONFIG_OBC at full width, 512x512x25 fp32, as in 7b
   (launches a step asserted: K1 4, K2 0, K3 2, all of them the
   open-face instance, K3m 0), with the dyes held to [0, 1] on the
   compute domain;
7c. the two at full width, 512x512x25 fp32, as in 7b (launches a step
   asserted: K1 4, all porous in B1, K2 1, K3m 2), and for B1 the SAL
   call alone (CUDA events) and one profiled dynamics-only step with
   the device time and kernels of the porous fractions (profile_step's
   ranges);
6e. the rest of the first breadth item: configs.BENCH_CONFIG_STOCH
   (bench.py's CONFIG with THICKNESSDIFFUSE_FIRST, DIABATIC_FIRST, GME,
   Stanley with STOCH_EOS, SPPT and SKEB; entry.build_full's "stoch")
   at 32x32x6 in fp64 for 4 steps, card against CPU, the SPPT and SKEB
   pattern carries included (1e-9);
7e. BENCH_CONFIG_STOCH at full width, 512x512x25 fp32, as in 7b
   (launches a step asserted: K1 4, K2 1, K3m 2), its ms/step beside
   bench.py's CONFIG of phase 7; step_pattern and apply_skeb alone
   (CUDA events); one thermodynamic and one dynamics-only step under
   the profiler with profile_step's ranges: device time and kernels of
   the patterns, SPPT, SKEB, the Stanley terms under STOCH_EOS and GME;
6f. the column physics of the third breadth item: configs.BENCH_CONFIG_B3
   (ePBL with the Langmuir factor, kappa-shear, convection, double
   diffusion, tidal, law-of-the-wall and ML-radiation mixing, full
   convection, frazil, geothermal heating; Z* ALE), the same text with
   PP81 in place of kappa-shear, and BENCH_CONFIG_BML (layered: the bulk
   mixed layer, LMD94, diffusive entrainment, regularization, frazil),
   through entry.build_full at 32x32x6 in fp64 in a weakly stratified
   400 m column for 4 steps, card against CPU (1e-9), the frazil field
   and the shear-viscosity and MLD carries included;
7f. BENCH_CONFIG_B3 and BENCH_CONFIG_BML at full width, 512x512x25 fp32,
   as in 7b (launches a step asserted: K1 4, K2 1, K3m 2), their ms/step
   by kind of step beside bench.py's CONFIG and its layered variant of
   phase 7, the peak of max_memory_allocated, finite fields and frazil;
   one thermodynamic step under the profiler with profile_step's ranges:
   device time, host time and kernels of set_diffusivity, kappa-shear,
   ePBL, full convection, frazil, the bulk mixed layer, entrainment and
   regularization;
6g. the lateral parameterizations of the fourth breadth item:
   configs.BENCH_CONFIG_B4 (MEKE, VarMix with the EOS slopes, neutral
   diffusion, the boundary diffusion in KPP's boundary layer, the
   interface filter and the internal tides, 24 angles; Z* ALE) and
   BENCH_CONFIG_B4V (layered: the Visbeck diffusivities, the resolution
   scaling of KH, KHTH and KHTR, the mixed layer's epipycnal diffusion,
   GM first; in the weakly stratified 400 m column of 6f) through
   entry.build_full at 32x32x6 in fp64 for 4 steps, card against CPU
   (1e-9), MEKE's energy and the internal-tide, MLD and shear-viscosity
   carries included, B4V's concentrations by their contents as BML's
   (its shear-viscosity carry printed: it moves with the last bits),
   and the internal-tide energy by its total (its modal speeds are
   ill-conditioned in the noise's statically unstable columns);
7g. BENCH_CONFIG_B4 and BENCH_CONFIG_B4V at full width, 512x512x25
   fp32, as in 7b (launches a step asserted: K1 4, K2 1, K3m 2), their
   ms/step by kind of step beside bench.py's CONFIG and BML, the peak of
   max_memory_allocated, finite fields, MEKE's energy and the
   internal-tide energy finite and non-negative; one thermodynamic step
   under the profiler with profile_step's ranges: device time, host time
   and kernels of VarMix, MEKE, the interface filter, neutral and
   boundary diffusion, the epipycnal diffusion and the internal tides
   with their wave speeds;
6h. the other equations of state and the hybrid coordinates of the
   fifth and sixth breadth items: configs.BENCH_CONFIG_HYBGEN (TEOS10,
   the hybgen coordinate with PPM_HYBGEN and WENO_HYBGEN remaps, the
   initial grid regridded three times), BENCH_CONFIG_ADAPT (ROQUET_RHO,
   ADAPTIVE, PLM_HYBGEN) and BENCH_CONFIG_UNMIX (ROQUET_SPV, HYCOM1 with
   hybgen unmixing) through entry.build_full at 32x32x6 in fp64 for 3
   steps, card against CPU (1e-9 on h, u, v, T, S, age, eta, uh and vh),
   then each in fp32 on the card against fp64 (finite; the departure
   printed);
6i. every EQN_OF_STATE form's density (with and without rho_ref),
   spec_vol (with and without spv_ref), derivatives, compressibility and
   second derivatives on seeded T, S > 0 and p at 25x66x66, card against
   CPU in fp64 (1e-12; 5e-12 for d2rho/dS2 of the polynomial forms); and
   hybgen_regrid, hybgen_unmix, the ADAPTIVE coordinate and the three
   hybgen remap schemes (by the remapped cells' contents) on seeded
   25-layer columns, card against CPU in fp64 (1e-12; ADAPTIVE 1e-11, whose stiff grid diffusion amplifies the
   last bit of the column sums, which the card takes in another order);
7h. BENCH_CONFIG_HYBGEN and BENCH_CONFIG_ADAPT at full width, 512x512x25
   fp32, as in 7b (launches a step asserted: K1 4, K2 1, K3m 2), their
   ms/step beside bench.py's CONFIG of phase 7; one regrid and one
   density call of the text's EOS alone (CUDA events, host clock and
   their device kernels); one thermodynamic step under the profiler with
   profile_step's ranges: device time, host time and kernels of the ALE
   call, the regrid, the remaps and the polynomial EOS;
6x. the ninth breadth item: configs.BENCH_CONFIG_FILE (topography, z-file
   T/S, ALE sponge, monthly wind and buoyancy files and a data_table, from
   configs.write_file_inputs) through entry.build_full at 32x32x6 in fp64
   for 3 steps, card against CPU (1e-9; the largest printed); and its
   modules card against CPU in fp64 (1e-12): the land fill and bilinear
   regrid of the z file, the z-space initial T/S, the sponge targets
   and the layer, ALE (33 reference levels onto 6) and interface
   sponges, and the data override with the file forcing at a model time;
7i. BENCH_CONFIG_FILE at full width, 512x512x25 fp32, as in 7b (launches
   a step asserted: K1 4, K2 1, K3m 2), its ms/step beside bench.py's
   CONFIG of phase 7, and one thermodynamic step under the profiler with
   profile_step's ranges: the sponge, the file forcing and the data
   override (device time, host time, kernels);
6y. the seventh breadth item: configs.BENCH_CONFIG_BGC (the MARBL-shaped
   coupler with every channel fed from configs.write_bgc_inputs, the
   coupled CFCs and pseudo-salt: 13 passive tracers) through
   entry.build_full at 32x32x6 in fp64 for 3 steps, card against CPU
   (2.5e-12 on every field and tracer; launches K1 4, K2 1, K3m 2 a
   step); and its modules card against CPU in fp64 (1e-12), with the
   ideal packages of IDEAL_LINES beside the coupler: every tracer's
   initial field and column function, the gas fluxes, the coupler's
   column physics (with the shortwave's light, and through the implicit
   vertical diffusion), NPZD, the restoring remap and step_offline;
7j. BENCH_CONFIG_BGC at full width, 512x512x25 fp32, as in 7b (launches
   a step asserted: K1 4, K2 1, K3m 2), its ms/step and peak memory
   beside bench.py's CONFIG of phase 7, every BGC tracer >= 0, and one
   thermodynamic step under the profiler with profile_step's ranges: the
   coupler's column physics and its restoring remap, advect_tracers, the
   tracer diffusion, the diabatic driver and the ALE call and remaps
   (device time, host time, kernels);
7k. offline mode at full width: step_offline on 7j's tracers from the
   (uhtr, vhtr, h_end) of 4 thermodynamic intervals recorded through
   step.offline_fields(), ms a step by CUDA events, no kernel launched,
   and each tracer without a column function keeping its content over a
   step to 1e-5 (fp32);
6z. the eighth breadth item: configs.BENCH_CONFIG_SHELF (bench.py's
   CONFIG under a 500 m ice shelf over the ISOMIP profile, closed in x)
   through entry.build_full at 32x32x6 in fp64 for 3 steps, card against
   CPU (2.5e-12 on every field and tracer; launches K1 4, K2 1, K3m 2 a
   step); then the shelf's modules card against CPU in fp64 at SSA_TOL
   (7.5e-14, ten times the JAX package's own spread on a default SSA
   solve): three_equation_melt, the default SSA solve and two steps of
   step_shelf (grounding, Coulomb friction, melt, the front advancing,
   the ice temperature) on tests/test_isomip_shelf.py's 48x8 ISOMIP
   cavity, and the shelf-only driver on tests/test_shelf_coupling.py's
   case (its shelf.stats lines and shelf_final.nc);
6t. the rest of the tenth breadth item at 32x32x6 in fp64, card against
   CPU: the forcing library (the HURR text's hurricane at two times,
   its single-column and BR-benchmark variants, the CVMix tests' wind
   and fluxes, the BFB restoring and the dumbbell's seesaw and
   restoring) to 1e-12; configs.BENCH_CONFIG_HURR over 3 steps to
   2.5e-12 (launches a step asserted); one ODA cycle (2 members, 2
   steps, the EnKF against a synthetic SST) and one coupling interval of
   the NUOPC-shaped cap (2 steps under seeded import fields), both from
   the seeded perturbation of phase 6's state, to 2.5e-12 (the exported
   sea-level slopes to twice the sea level's own difference over the
   spacing: the sea level is sum(h) minus the 4000 m depth); the cap's
   interval from rest, its u, v, sea level and slopes each to 4 times
   the absolute difference that one ulp of the initial h makes on the
   CPU, with the largest difference's place logged; particles after 4
   RK2 steps in the same flow to 1e-12;
7l. BENCH_CONFIG_SHELF at full width, 512x512x25 fp32, as in 7b
   (launches a step asserted: K1 4, K2 1, K3m 2), its ms/step and peak
   memory beside bench.py's CONFIG of phase 7, the melt rate's range
   under the shelf, and one thermodynamic step under the profiler with
   profile_step's ranges: the shelf's coupling (ice_shelf/fluxes) beside
   the pressure force, the diabatic driver and the ALE call;
7m. the shelf-only step (drivers/shelf_solo.py's build) at full width:
   512x512 cells of 2 km, an 800 m channel profile over 512 km, the flat
   1000 m bed with grounding on, 12 h steps in fp64: SHELF_SOLO_STEPS
   steps by CUDA events (no kernel of csrc launched), the last CG
   residual norm of each Picard refresh, the ice volume kept to 1e-8,
   and one more step under the profiler (profile_step's ice_shelf/ssa
   range): its kernels and idle share;
7n. BENCH_CONFIG_HURR at full width, 512x512x25 fp32, as in 7b
   (launches a step asserted: K1 4, K2 1, K3m 2), its ms/step and peak
   memory beside bench.py's CONFIG of phase 7, the storm's peak stress,
   and one thermodynamic step under the profiler with profile_step's
   ranges: the hurricane's stress (forcing/hurricane) beside the
   pressure force, the diabatic driver and the ALE call;
7o. the NUOPC-shaped cap (drivers/nuopc_cap.py) on bench.py's CONFIG at
   full width in fp32: realize, then CAP_INTERVALS timed coupling
   intervals of CAP_STEPS steps each (import of fields made from a seed
   with numpy, advance, export), launches asserted, ms per interval,
   peak memory, the export fields finite on the compute domain, and one
   device kernel per launch in a traced interval;
7p. the ODA ensemble (oda/driver.py) over bench.py's CONFIG at full
   width in fp32: ODA_MEMBERS members stepped in turn, ODA_CYCLES
   cycles of ODA_STEPS steps with the EnKF against a synthetic SST,
   launches asserted, ms per member step, peak memory beside one
   state's size, the cycles' SST mean and spread;
8. the solo driver (``python -m mom6_torch.drivers.solo``) on temporary
   case directories: cases/double_gyre for 0.5 days (36 steps, fp64) on
   the card and with --cpu, every ocean.stats field agreeing to 1e-9
   relative (SL and Me to 1e-12 absolute), K1, K2 and K3 launched and
   K3m not, the
   substep counts the DTBT resets chose printed; then bench.py's CONFIG
   with BT_WIDE_HALO_PERIOD = 2 at 512x512x25 fp32 for 12 steps
   (ocean.stats every 4): every line finite with |Me| <= 1e-6, nstep
   27 throughout, K1, K2 and K3m launched and K3 not, the final state
   bitwise equal to 12 steps of entry.build_full().step_fn in the same
   process, the driver's ms/step beside the bare loop's, one
   stat_sums + collect_stats call timed and the driver's peak memory;
   then cases/tc0 (unsplit, 4x4x1) for its 4 days in fp64, card against
   --cpu as double_gyre, K1 untargeted alone launched; then cases/tc3
   (four Flather/Orlanski segments, with SSH = 0.1 m on one and three
   dyes) through the driver in fp64, card against --cpu, K3 launched
   only as its open-face instance; and cases/ref_tc0 (unsplit,
   SIMPLE_2ND_PPM_CONTINUITY, DEBUG and DIAG_AS_CHKSUM) through the
   driver in fp64 on the card against its golden in
   tests/goldens_ref_cases.json, its chksum_debug and chksum_diag
   equal line for line to a --cpu run's, K1 untargeted alone launched;
   and cases/layer_mode and cases/benchmark (spherical grid, bowl,
   WRIGHT_FULL, the bulk mixed layer by its layered default) for 4
   steps in fp64, ocean.stats every step, card against --cpu as
   double_gyre; and cases/ref_tc1 (Mercator, the benchmark topography,
   thicknesses and T/S, layered, Visbeck VarMix, RESOLN_SCALED_*,
   DIFFUSE_ML_TO_INTERIOR) and cases/ref_tc2 (spherical, halfpipe, Z*,
   MEKE, VarMix, neutral diffusion, ePBL) for their golden's steps in
   fp64 on the card, against tests/goldens_ref_cases.json at the
   tolerances of tests/test_ref_cases.py; then cases/tc4 (topography,
   T/S and sponge from files, Z*) through the driver in fp64 on the card
   against the JAX driver's ocean.stats (TC4_JAX_STATS, as
   tests/test_torch_cases.py holds the port on the CPU), cases/ref_tc4
   (mosaic grid, z-file initial state, ALE sponge, COORD_CONFIG linear)
   against its golden, and cases/tc2 (PPM_H4 over the spoon's vanished
   layers) finite with the step and day columns of the JAX driver's
   ocean.stats (TC2_JAX_STEPS); then cases/ref_tc3 (circle_obcs,
   layer_ref, four Flather/Orlanski edges, the DOME dyes) in fp64 on the
   card against its golden, K3 launched only as its open-face instance
   and K2 not; then the offline round trip of
   tests/test_offline_driver.py in fp64: online with
   WRITE_OFFLINE_FIELDS on the card, then OFFLINE_TRACER_MODE from its
   files on the card and with --cpu (no kernel launched), the uniform dye
   equal to the online dye to 1e-10, a dye in a box equal to the --cpu
   run's to 1e-12, the content of each kept to 1e-12; last,
   cases/phillips for its 2 days in fp64 on the card against the JAX
   driver's ocean.stats (PHILLIPS_JAX_STATS, held as tc4's); and a copy
   of cases/double_gyre with USE_PARTICLES for 0.5 days in fp64, on the
   card and with --cpu, particles.nc equal to 1e-12.  Each run has every
   launch counter zeroed just before it and read just after.

The line before the last is the JSON ``kernels`` record (the porous K1
instance and K3's open-face instance have records of their own); the
last line is ``{"ok": true, "device": {...}}``.
"""

import dataclasses
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
GYRE = (44, 40, 2)             # cases/double_gyre: a closed basin
GYRE_DAYS = "0.5"              # 36 steps of 1200 s
BENCH_STEPS = 12               # bench.py's CONFIG through the driver
BENCH_STATS_EVERY = 4          # its ENERGYSAVEDAYS, in steps
BENCH_NSTEP = 27               # its barotropic substep count
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

# The K1/K2 modes of the RK2b and unsplit steppers and the reference
# cases, by their ContinuityCfg switches: "untargeted" is K1 with no
# barotropic transport to match (one pass, no Newton step), in the
# default scheme; the others are edge schemes, or the volume-based CFL,
# of K1 (matched and untargeted) and K2.  The edge values of one cell
# cost ~100 operations with either limiter (ppm.cuh), ~10 for
# simple_2nd and none for upwind_1st.
MODES = {"untargeted": {}, "upwind_1st": {"upwind_1st": True},
         "simple_2nd": {"simple_2nd": True},
         "monotonic": {"monotonic": True}, "vol_cfl": {"vol_cfl": True}}
OPS_EDGES_BY = {"untargeted": 100, "upwind_1st": 0, "simple_2nd": 10,
                "monotonic": 100, "vol_cfl": 100, "porous": 100,
                "porous_untargeted": 100}
# the porous faces' modes of K1 (matched and untargeted) and K2, on a
# grid with ridges from this seed
POROUS_MODES = ("porous", "porous_untargeted")
POROUS_SEED = 11
# launches a step on each dynamics path of build_full (K1u: the
# untargeted K1 sweeps among K1's)
PER_STEP = {"rk2b": {"K1": 8, "K2": 1, "K3": 0, "K3m": 2, "K1u": 4,
                     "K1p": 0, "K3o": 0},
            "unsplit": {"K1": 6, "K2": 0, "K3": 0, "K3m": 0, "K1u": 6,
                        "K1p": 0, "K3o": 0},
            "b1": {"K1": 4, "K2": 1, "K3": 0, "K3m": 2, "K1u": 0, "K1p": 4,
                   "K3o": 0},
            "nonbouss": {"K1": 4, "K2": 1, "K3": 0, "K3m": 2, "K1u": 0,
                         "K1p": 0, "K3o": 0},
            # open boundaries: no BT_cont, period 1, K3 as its open-face
            # instance (K3o)
            "obc": {"K1": 4, "K2": 0, "K3": 2, "K3m": 0, "K1u": 0, "K1p": 0,
                    "K3o": 2},
            # the rest of the first breadth item: the same kernels as
            # bench.py's CONFIG
            "stoch": {"K1": 4, "K2": 1, "K3": 0, "K3m": 2, "K1u": 0,
                      "K1p": 0, "K3o": 0},
            # the column physics of the third breadth item, with Z* ALE
            # and layered: the same kernels again
            "b3": {"K1": 4, "K2": 1, "K3": 0, "K3m": 2, "K1u": 0,
                   "K1p": 0, "K3o": 0},
            "bml": {"K1": 4, "K2": 1, "K3": 0, "K3m": 2, "K1u": 0,
                    "K1p": 0, "K3o": 0}}
PER_STEP["b3pp81"] = PER_STEP["b3"]
# the lateral parameterizations of the fourth breadth item, with Z* ALE
# and layered: the same kernels again
PER_STEP["b4"] = PER_STEP["b4v"] = PER_STEP["b3"]
# the profile_step ranges of the fourth breadth item, and those of them
# each text must run in a thermodynamic step
LATERAL_PHASES = ("varmix/resolution_function", "varmix/eady_rate",
                  "meke/step_meke", "thickness_diffuse", "interface_filter",
                  "neutral_diffusion", "hor_bnd_diffusion", "tracer_hordiff",
                  "tracer_hordiff/ml_epipycnal_diff", "internal_tides",
                  "internal_tides/wave_speeds",
                  "internal_tides/step_internal_tides",
                  "diabatic/set_diffusivity")
LATERAL_NEEDED = {"b4": ("varmix/resolution_function", "meke/step_meke",
                         "interface_filter", "neutral_diffusion",
                         "hor_bnd_diffusion", "internal_tides",
                         "internal_tides/wave_speeds"),
                  "b4v": ("varmix/resolution_function", "varmix/eady_rate",
                          "tracer_hordiff/ml_epipycnal_diff")}
# the other equations of state and the hybrid coordinates of the fifth and
# sixth breadth items: the same kernels again
PER_STEP["hybgen"] = PER_STEP["adapt"] = PER_STEP["unmix"] = PER_STEP["b3"]
# the ninth breadth item: the same kernels again
PER_STEP["file"] = PER_STEP["b3"]
# the profile_step ranges of the hybrid coordinates and the polynomial
# equations of state, and those each text must run in a thermodynamic step
HYBRID_PHASES = ("ale", "ale/hybgen_unmix", "ale/build_grid",
                 "ale/build_grid/hybgen_regrid", "ale/build_grid/build_adapt",
                 "ale/remap_column_means", "eos_poly",
                 "dynamics/pressure_force")
HYBRID_NEEDED = {"hybgen": ("ale/build_grid/hybgen_regrid", "eos_poly"),
                 "adapt": ("ale/build_grid/build_adapt", "eos_poly")}
# the ninth breadth item's profile_step ranges, and those of them a
# thermodynamic step of BENCH_CONFIG_FILE must run
FILE_PHASES = ("sponge", "sponge_eta", "file_forcing", "data_override/mech",
               "data_override/fluxes", "ale", "ale/remap_column_means",
               "diabatic")
FILE_NEEDED = ("sponge", "file_forcing", "data_override/mech",
               "data_override/fluxes")
# the seventh and eighth breadth items: the same kernels again
PER_STEP["bgc"] = PER_STEP["shelf"] = PER_STEP["b3"]
# the profile_step ranges of a thermodynamic step of BENCH_CONFIG_BGC,
# each of which it must run: the coupler's column physics and its
# restoring remap, and the phases whose work grows with the tracer count
BGC_PHASES = ("bgc", "bgc/restoring", "advect_tracers", "tracer_hordiff",
              "diabatic", "ale", "ale/remap_column_means")
# the ideal packages beside the BGC text's coupler in the card-against-CPU
# module checks, at SMALL_FULL's 32x32 cells of 10 km (positions in km)
IDEAL_LINES = """USE_REGIONAL_DYES = True
DYE_SOURCE_MINLON = 80.0
DYE_SOURCE_MAXLON = 240.0
DYE_SOURCE_MINLAT = 60.0
DYE_SOURCE_MAXLAT = 200.0
USE_DOME_TRACER = True
USE_BOUNDARY_IMPULSE_TRACER = True
IMPULSE_SOURCE_TIME = 5000.0
USE_OIL_TRACER = True
OIL_SOURCE_LONGITUDE = 165.0
OIL_SOURCE_LATITUDE = 155.0
OIL_SOURCE_LAYER = 1
OIL_DECAY_DAYS = 3.0
USE_ADVECTION_TEST_TRACER = True
ADVECTION_TEST_X_ORIGIN = 160.0
ADVECTION_TEST_Y_ORIGIN = 160.0
ADVECTION_TEST_X_WIDTH = 80.0
ADVECTION_TEST_Y_WIDTH = 60.0
"""
# the offline round trip of tests/test_offline_driver.py: its case (a
# reentrant channel, adiabatic and layered, 8 steps of 1200 s, a
# thermodynamic step every second) and the dye in a box that moves it
OFFLINE_CASE = """SPLIT = True
ENABLE_THERMODYNAMICS = False
ADIABATIC = True
DT = 1200.0
DT_THERM = 2400.0
DAYMAX = 0.11111111111
ENERGYSAVEDAYS = 0.055555
NIGLOBAL = 10
NJGLOBAL = 10
NK = 3
GRID_CONFIG = "cartesian"
AXIS_UNITS = "k"
LENLAT = 100.0
LENLON = 100.0
TOPO_CONFIG = "flat"
MAXIMUM_DEPTH = 300.0
F_0 = 1.0E-04
REENTRANT_X = True
THICKNESS_CONFIG = "uniform"
WIND_CONFIG = "gyres"
TAUX_MAGNITUDE = 0.2
USE_REGIONAL_DYES = True
"""
DYE_BOX = """DYE_SOURCE_MINLON = 20.0
DYE_SOURCE_MAXLON = 60.0
DYE_SOURCE_MINLAT = 30.0
DYE_SOURCE_MAXLAT = 70.0
"""
OFFLINE_STEPS = 4              # 7k's offline steps (thermo intervals)
# cases/tc4 through the JAX driver on the CPU in fp64 (most XLA
# optimizations off), the ocean.stats lines that tests/test_torch_cases.py
# holds the port's to on the CPU
TC4_JAX_STATS = """\
     0,      0.000,       0, En 2.7578984764E-23, CFL  0.00000, SL  6.5711E-11, M 5.799776E+15, S  34.1031, T  11.1749, Me  0.00E+00
     2,      0.014,       0, En 6.9201265738E-04, CFL  0.01813, SL  6.5841E-11, M 5.799776E+15, S  34.1031, T  11.1749, Me  3.45E-16
     4,      0.028,       0, En 2.4147076918E-03, CFL  0.03421, SL  6.5854E-11, M 5.799776E+15, S  34.1031, T  11.1748, Me  3.45E-16
     6,      0.042,       0, En 4.8720486157E-03, CFL  0.04746, SL  6.5861E-11, M 5.799776E+15, S  34.1032, T  11.1748, Me  3.45E-16
"""
# the (step, day) columns of cases/tc2's ocean.stats from the JAX driver:
# its other columns part from the port's (the JAX package's jitted and
# eager runs of this case part by 2.2e-5 in T after one step)
TC2_JAX_STEPS = [(0, 0.0), (6, 0.062), (12, 0.125), (18, 0.188),
                 (24, 0.25)]
# cases/phillips (DAYMAX 2, 96 steps) through the JAX driver on the CPU in
# fp64 (most XLA optimizations off): phase 8 holds the port's run to it
PHILLIPS_JAX_STATS = """\
     0,      0.000,       0, En 3.2305830439E-02, CFL  0.00720, SL  0.0000E+00, M 3.179520E+17, S   0.0000, T   0.0000, Me  0.00E+00
    24,      0.500,       0, En 3.1411820636E-02, CFL  0.00888, SL -1.5247E-14, M 3.179520E+17, S   0.0000, T   0.0000, Me  0.00E+00
    48,      1.000,       0, En 3.0546423789E-02, CFL  0.01139, SL -1.0658E-14, M 3.179520E+17, S   0.0000, T   0.0000, Me  0.00E+00
    72,      1.500,       0, En 3.0200096982E-02, CFL  0.00595, SL -1.1843E-14, M 3.179520E+17, S   0.0000, T   0.0000, Me  0.00E+00
    96,      2.000,       0, En 3.0447779283E-02, CFL  0.00682, SL -2.2501E-14, M 3.179520E+17, S   0.0000, T   0.0000, Me  0.00E+00
"""
# the ice shelf of the eighth breadth item: the same kernels again
SHELF_PHASES = ("ice_shelf/fluxes", "dynamics/pressure_force", "diabatic",
                "ale")
# the shelf-only step at full width: 512x512 cells of 2 km, an 800 m
# channel profile over 512 km, the driver's flat 1000 m bed with
# grounding on, 12 h steps (drivers/shelf_solo.py), fp64
SHELF_SOLO_TEXT = """NIGLOBAL = 512
NJGLOBAL = 512
LENLON = 1024.0
LENLAT = 1024.0
DT_ICE_DYNAMICS = 43200.0
DAYMAX = 1.5
ICE_PROFILE_CONFIG = channel
SHELF_MAX_THICKNESS = 800.0
SHELF_LENGTH_LON = 512.0
"""
SHELF_SOLO_STEPS = 3
# tests/test_shelf_coupling.py's shelf-only case, card against CPU
SHELF_SOLO_SMALL = """NIGLOBAL = 12
NJGLOBAL = 8
LENLON = 120.0
LENLAT = 80.0
DT_ICE_DYNAMICS = 43200.0
DAYMAX = 1.0
ICE_PROFILE_CONFIG = channel
SHELF_MAX_THICKNESS = 400.0
SHELF_LENGTH_LON = 60.0
"""
# the tenth breadth item: HURR runs the same kernels as bench.py's
# CONFIG; the cap's and the ODA ensemble's steps are all thermodynamic,
# with the same kernels again
PER_STEP["hurr"] = PER_STEP["b3"]
HURR_PHASES = ("forcing", "forcing/hurricane", "dynamics/pressure_force",
               "diabatic", "ale")
CAP_STEPS = 2                  # steps a coupling interval of the cap
CAP_ROUNDOFF_TIMES = 4         # 6t: the cap from rest, card vs cpu, over
                               # the difference one ulp of h makes
CAP_INTERVALS = 3              # timed intervals, after one warm-up
ODA_MEMBERS, ODA_CYCLES, ODA_STEPS = 4, 2, 2
# the particles of phase 8's copy of cases/double_gyre, in the top layer,
# recorded every 6 steps
PARTICLE_LINES = ("USE_PARTICLES = True\nPARTICLES_NX = 8\n"
                  "PARTICLES_NY = 6\n#override ENERGYSAVEDAYS = 0.0833333\n")
# ten times the JAX package's own spread on a default SSA solve
# (tools/ssa_spread.py; tests/test_torch_ice_shelf.py's SOLVE_TOL)
SSA_TOL = 7.5e-14
EOS_FORMS = ("LINEAR", "WRIGHT", "WRIGHT_FULL", "WRIGHT_RED", "UNESCO",
             "JACKETT_06", "ROQUET_RHO", "ROQUET_SPV", "TEOS10")
# the column texts at 32x32x6 take a weakly stratified 400 m column, as
# their CPU tests do: kappa-shear needs Ri < 0.25 somewhere, and under
# layers of hundreds of metres ePBL's first-interface decision compares
# a roundoff-sized cost with a TKE decayed below it, a tie that the last
# bits of T decide (ROADMAP.md Queue 3)
COLUMN = "#override MAXIMUM_DEPTH = 400.0\n#override T_RANGE = 0.2\n"
# the profile_step ranges of the column physics of a thermodynamic step
COLUMN_PHASES = ("diabatic", "diabatic/set_diffusivity",
                 "diabatic/set_diffusivity/kappa_shear",
                 "diabatic/energetic_pbl", "diabatic/full_convection",
                 "diabatic/make_frazil", "diabatic/bulk_mixed_layer",
                 "diabatic/entrainment_diffusive",
                 "diabatic/regularize_layers")
# the layered cases through the driver: 4 steps of 900 s, with
# ocean.stats every step
LAYER_DAYS = "0.0417"
LAYER_EDITS = (("ENERGYSAVEDAYS = 0.125",
                "ENERGYSAVEDAYS = 0.010416666666666666"),)
# the profile_step ranges of the stochastic pieces, the STOCH_EOS-scaled
# Stanley terms and GME, read from a profiled thermodynamic and a
# dynamics-only step of BENCH_CONFIG_STOCH
STOCH_PHASES = ("pattern/init_pattern", "pattern/step_pattern", "apply_sppt",
                "apply_skeb", "dynamics/stoch_eos_multiplier",
                "dynamics/pressure_force/calc_varT",
                "dynamics/pressure_force/density_second_dT2",
                "dynamics/gme_inputs",
                "dynamics/horizontal_viscosity/gme_stress")
# cases/tc3 through the driver, with SSH = 0.1 m on its third segment and
# three dyes, so that its statistics are not all zero
TC3_DAYS = "0.05"
TC3_EDITS = (('OBC_SEGMENT_003_DATA = "U=value:0.0,V=value:0.0,SSH=value:0.0"',
              'OBC_SEGMENT_003_DATA = "U=value:0.0,V=value:0.0,SSH=value:0.1"'),
             ("KV = 1.0E-04", "KV = 1.0E-04\nNUM_DYE_TRACERS = 3"))
# operations of the open faces a substep: two Flather updates of ~8
# operations at each open face
OPS_FLATHER = 8
# the barotropic options under which K3 and K3m are checked once more
BT_OPTIONS = dict(strong_drag=True, bound_bt_corr=True, maxcfl_bt_cont=1e-4)
NEW_STEPS = 12                 # timed steps of each new full-width path
TC0_DAYS = "4"                 # cases/tc0: 4 steps of one day

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
# the porous instance of K1 (sweep_kernel<T, AXIS, TARGETED, true>)
POROUS_KERNEL = dict(name="continuity_sweep_porous", route="cuda",
                     source="mom6_torch/csrc/continuity.cu",
                     replaces="mom6_tpu/core/continuity_pallas.py:193")
# K3's open-face instance (subcycle_kernel<T, RESIDENT, true>): the Pallas
# subcycle K3 replaces, on the path where the JAX package runs its jnp
# substep instead (barotropic.py:651-670)
OBC_KERNEL = dict(name="barotropic_subcycle_obc", route="cuda",
                  source="mom6_torch/csrc/barotropic.cu",
                  replaces="mom6_tpu/core/barotropic_pallas.py:164")
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
    "K3o": {"float64": 0.0, "float32": 0.0},
}


def log(msg):
    print(msg, flush=True)


def rel_err(ref, out, H=4):
    """(max relative, max absolute) error on the compute domain of halo
    ``H``, on the whole array with H = 0."""
    sl = slice(H, -H) if H else slice(None)
    a = ref[..., sl, sl].double()
    b = out[..., sl, sl].double()
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
        self.err = {k: {} for k in (*KERNELS, "K3o")}  # dtype -> (rel, abs)
        self.modes = {}                          # (kernel, mode) -> abs

    def check(self, kernel, dtype, label, ref, out, tol_key=None, H=4,
              exact=False):
        rel, diff = rel_err(ref, out, H)
        tol = 0.0 if exact else TOL[tol_key or kernel][dtype]
        log(f"  {kernel} {label} {dtype}: max rel err {rel:.3e} "
            f"(limit {tol:.0e}), max abs err {diff:.3e}")
        if not rel <= tol:
            raise AssertionError(f"{kernel} {label} {dtype}: {rel:.3e} > "
                                 f"{tol:.0e}")
        old = self.err[kernel].get(dtype, (0.0, 0.0))
        self.err[kernel][dtype] = (max(old[0], rel), max(old[1], diff))

    def check_all(self, kernel, dtype, label, ref: dict, out: dict, H=4,
                  exact=False):
        """Every field of ``ref`` against ``out``, logged as one line
        naming the worst field; ``exact`` requires equality."""
        tol = 0.0 if exact else TOL[kernel][dtype]
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
        return max(e[1] for e in errs.values())

    def check_mode(self, kernel, mode, dtype, label, ref: dict, out: dict):
        """``check_all`` with equality required, the worst absolute
        error kept per kernel and mode."""
        diff = self.check_all(kernel, dtype, f"{mode} {label}", ref, out,
                              exact=True)
        key = (kernel, mode)
        self.modes[key] = max(self.modes.get(key, 0.0), diff)


def make_grid(ni, nj, nk, dtype, device=None, reentrant_y=False,
              reentrant_x=True):
    from mom6_torch.core.grid import cartesian_grid
    from mom6_torch.core.vertical_grid import VerticalGrid
    from mom6_torch.parallel.domain import Domain
    device = device or DEV
    d = Domain(ni=ni, nj=nj, halo=4, reentrant_x=reentrant_x,
               reentrant_y=reentrant_y)
    g = cartesian_grid(d, lenlon_km=ni * 10.0, lenlat_km=nj * 10.0,
                       f0=1e-4, beta=2e-11, max_depth=4000.0,
                       device=device, dtype=dtype)
    vg = VerticalGrid.uniform(nk=nk, gint=0.005, device=device,
                              dtype=dtype)
    return d, g, vg


def continuity_inputs(ni, nj, nk, dtype, seed, reentrant_x=True):
    """Random layered state in the style of the JAX package's continuity
    tests: h ~ 160 +- 16 m, u/v ~ 0.3 m/s, visc_rem in [0.5, 1], and
    barotropic transports within 10% of the layer sum."""
    import numpy as np
    import torch
    d, g, vg = make_grid(ni, nj, nk, dtype, reentrant_x=reentrant_x)
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


def check_k1_k2(res, ni, nj, nk, dtype, timing=None, reentrant_x=True,
                exact=False):
    """K1 (both sweep orders) and K2 against their plain versions;
    ``exact`` requires equality (the closed-basin checks)."""
    from mom6_torch.core import continuity_cuda as cc
    from mom6_torch.core.continuity_ppm import (ContinuityCfg,
                                                continuity_ppm,
                                                set_up_bt_cont)
    d, g, vg, x = continuity_inputs(ni, nj, nk, dtype, seed=1,
                                    reentrant_x=reentrant_x)
    cfg = ContinuityCfg()
    dt = 600.0
    dn = str(dtype).split(".")[-1]
    shape = f"{nk}x{d.njh}x{d.nih}" + ("" if reentrant_x else " walled x")
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
                      getattr(ref, name), getattr(out, name), exact=exact)
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
                  getattr(out, name), "K2_turn" if turn else None,
                  exact=exact)
    if timing is not None:
        timing["K2"] = (cuda_ms(lambda: cc.set_up_bt_cont_cuda(*bargs), 20),
                        cuda_ms(lambda: set_up_bt_cont(*bargs), 3),
                        lambda: cc.set_up_bt_cont_cuda(*bargs))


def check_modes(res, ni, nj, nk, dtype, timing=None, reentrant_x=True):
    """K1 untargeted, and K1 (matched and untargeted, both orders) and K2
    in each other mode of MODES, against their plain versions, required
    equal; with ``timing`` each mode's K1 (untargeted for "untargeted",
    matched for the others) and K2 are timed into it."""
    from mom6_torch.core import continuity_cuda as cc
    from mom6_torch.core.continuity_ppm import (ContinuityCfg,
                                                continuity_ppm,
                                                set_up_bt_cont)
    d, g, vg, x = continuity_inputs(ni, nj, nk, dtype, seed=2,
                                    reentrant_x=reentrant_x)
    dt = 600.0
    dn = str(dtype).split(".")[-1]
    shape = f"{nk}x{d.njh}x{d.nih}" + ("" if reentrant_x else " walled x")
    matched = dict(uhbt=x["uhbt"], vhbt=x["vhbt"], visc_rem_u=x["vr_u"],
                   visc_rem_v=x["vr_v"])
    for mode, kw in MODES.items():
        cfg = ContinuityCfg(**kw)
        args = (g, vg, x["u"], x["v"], x["h"], dt, cfg)
        for targeted in (False,) if mode == "untargeted" else (False, True):
            tkw = matched if targeted else {}
            names = ("h", "uh", "vh") + (("u_cor", "v_cor", "du_cor",
                                          "dv_cor") if targeted else ())
            for x_first in (True, False):
                ref = continuity_ppm(*args, x_first=x_first, **tkw)
                out = cc.continuity_ppm_cuda(*args, x_first=x_first, **tkw)
                if not targeted and (out.u_cor is not None
                                     or out.du_cor is not None):
                    raise AssertionError(f"K1 {mode}: an untargeted sweep "
                                         "returned corrections")
                res.check_mode(
                    "K1", mode, dn,
                    f"{shape} {'matched' if targeted else 'untargeted'} "
                    f"x_first={x_first}", {n: getattr(ref, n) for n in names},
                    {n: getattr(out, n) for n in names})
            if timing is not None and targeted == (mode != "untargeted"):
                call = functools.partial(cc.continuity_ppm_cuda, *args,
                                         **tkw)
                timing[("K1", mode)] = (
                    cuda_ms(call, 20) / 2,
                    cuda_ms(lambda: continuity_ppm(*args, **tkw), 3) / 2,
                    call)
        if mode == "untargeted":
            continue
        bargs = args + (x["vr_u"], x["vr_v"])
        ref, out = set_up_bt_cont(*bargs), cc.set_up_bt_cont_cuda(*bargs)
        res.check_mode("K2", mode, dn, shape, ref._asdict(), out._asdict())
        if timing is not None:
            call = functools.partial(cc.set_up_bt_cont_cuda, *bargs)
            timing[("K2", mode)] = (cuda_ms(call, 20),
                                    cuda_ms(lambda: set_up_bt_cont(*bargs),
                                            3), call)


def mode_bound(kernel, mode, nk, njh, nih, item, dtn):
    """(bound_ms, bound_by) of one K1 sweep or one K2 call in ``mode``;
    a porous K1 sweep also reads the faces' open fractions (one more
    layered input) and multiplies each flux's mask by them."""
    P = njh * nih
    e = OPS_EDGES_BY[mode]
    por = kernel == "K1" and mode in POROUS_MODES
    if kernel == "K1" and mode in ("untargeted", "porous_untargeted"):
        # u, h (+ the fractions) + dlen, Idx, Iarea and the two masks in;
        # h, flux out
        work = ((4 + por) * nk * P + 5 * P,
                (e + OPS_FLUX + 4 + por) * nk * P)
    elif kernel == "K1":
        work = ((6 + por) * nk * P + 8 * P,
                (e + 7 * OPS_FLUX + 4 + 7 * por) * nk * P)
    else:
        work = (5 * nk * P + (22 if mode == "vol_cfl" else 21) * P,
                2 * (e + 6 * OPS_FLUX + 12) * nk * P)
    return bound(*work, item, dtn)


def mode_records(res, timing, shape):
    """Each timed mode's CUDA-event and profiler times, its plain
    version's and its bound, logged; returns {kernel: {mode: record}}."""
    nk, njh, nih = shape
    out = {}
    for (k, mode), (ms, plain_ms, call, *more) in timing.items():
        name, per_call = PROFILED[k]
        n_prof, n_all, dev_ms = profiled_kernels(
            call, name, PROFILE_REPS, PROFILE_REPS * per_call)
        if n_prof != PROFILE_REPS * per_call or n_all != n_prof:
            raise AssertionError(f"{k} {mode}: torch.profiler traced "
                                 f"{n_prof} {name} kernels ({n_all} in "
                                 f"all) in {PROFILE_REPS * per_call} "
                                 "launches, expected one each")
        b_ms, b_by = mode_bound(k, mode, nk, njh, nih, 4, "float32")
        unit = "per sweep" if k == "K1" else "per call"
        log(f"  {k} {mode}: {ms:.4f} ms {unit} (CUDA events), "
            f"{dev_ms / per_call:.4f} ms (profiler), bound {b_ms:.4f} ms "
            f"({b_by}), plain {plain_ms:.4f} ms, max abs err "
            f"{res.modes[(k, mode)]:.1e}")
        out.setdefault(k, {})[mode] = dict(
            ms=ms, profiled_device_ms=dev_ms / per_call, plain_ms=plain_ms,
            bound_ms=b_ms, bound_by=b_by, max_abs_err=res.modes[(k, mode)])
        if more:
            # the wrapper's time with the open fractions computed
            log(f"  {k} {mode}: {more[0]:.4f} ms {unit} through the "
                "wrapper, the plain open fractions included")
            out[k][mode]["with_fractions_ms"] = more[0]
    return out


def porous_grid(g, seed=POROUS_SEED):
    """``g`` with subgrid topography on its padded faces: the
    statistics of configs.topog_edge_fields (ridges on about a fifth
    of the faces) for its flat 4000 m bottom, as heights."""
    import torch
    from mom6_torch.configs import topog_edge_fields
    f = topog_edge_fields(tuple(g.bathyT.shape), seed)
    kw = dict(dtype=g.bathyT.dtype, device=g.bathyT.device)
    por = {}
    for s in "uv":
        for key, var in (("Dmax", "hi"), ("Dmin", "lo"), ("Davg", "av")):
            por[f"porous_{key}{s.upper()}"] = -torch.as_tensor(
                f[f"depth{s}_{var}"], **kw)
    return dataclasses.replace(g, **por)


def check_porous(res, ni, nj, nk, dtype, timing=None, reentrant_x=True):
    """K1 (both orders, matched and untargeted) and K2 on a porous grid
    against their plain versions, required equal; with ``timing`` the
    porous K1 (matched, and untargeted) and K2 are timed into it: K1's
    kernels with the open fractions computed beforehand, and the
    wrapper as it runs (fractions included)."""
    from mom6_torch.core import continuity_cuda as cc
    from mom6_torch.core.continuity_ppm import (ContinuityCfg,
                                                continuity_ppm,
                                                set_up_bt_cont)
    d, g, vg, x = continuity_inputs(ni, nj, nk, dtype, seed=4,
                                    reentrant_x=reentrant_x)
    g = porous_grid(g)
    dt, cfg = 600.0, ContinuityCfg()
    dn = str(dtype).split(".")[-1]
    shape = f"{nk}x{d.njh}x{d.nih}" + ("" if reentrant_x else " walled x")
    if x["h"].is_cuda:
        p, = cc.launch_plan(x["h"], (0,), True)
        log(f"  K1 porous tile plan {shape} {dn}: x {p.faces} faces x "
            f"{p.across} across, {p.layers} layers x {p.chunks} chunk"
            f"{'s' if p.chunks > 1 else ''}, {p.blocks} blocks, "
            f"{p.smem_bytes} B")
    args = (g, vg, x["u"], x["v"], x["h"], dt, cfg)
    matched = dict(uhbt=x["uhbt"], vhbt=x["vhbt"], visc_rem_u=x["vr_u"],
                   visc_rem_v=x["vr_v"])
    for targeted in (True, False):
        mode = "porous" if targeted else "porous_untargeted"
        tkw = matched if targeted else {}
        names = ("h", "uh", "vh") + (("u_cor", "v_cor", "du_cor", "dv_cor")
                                     if targeted else ())
        for x_first in (True, False):
            ref = continuity_ppm(*args, x_first=x_first, **tkw)
            before = cc.continuity_ppm_cuda.porous_launches
            out = cc.continuity_ppm_cuda(*args, x_first=x_first, **tkw)
            if x["h"].is_cuda and \
                    cc.continuity_ppm_cuda.porous_launches != before + 2:
                raise AssertionError("K1 porous: the porous instance was "
                                     "not launched for both sweeps")
            res.check_mode("K1", mode, dn, f"{shape} x_first={x_first}",
                           {n: getattr(ref, n) for n in names},
                           {n: getattr(out, n) for n in names})
        if timing is not None:
            vr = (x["vr_u"], x["vr_v"]) if targeted else (None, None)
            hbt = (x["uhbt"], x["vhbt"]) if targeted else (None, None)
            por_x = cc.porous_factor(g, x["h"], "U")
            h1 = cc._sweep(g, vg, x["u"], x["h"], vr[0], hbt[0], dt, cfg, 0,
                           por_x)[0]
            por_y = cc.porous_factor(g, h1, "V")

            def kernels(vr=vr, hbt=hbt, por_x=por_x, h1=h1, por_y=por_y):
                cc._sweep(g, vg, x["u"], x["h"], vr[0], hbt[0], dt, cfg, 0,
                          por_x)
                cc._sweep(g, vg, x["v"], h1, vr[1], hbt[1], dt, cfg, 1,
                          por_y)
            wrapped = functools.partial(cc.continuity_ppm_cuda, *args, **tkw)
            timing[("K1", mode)] = (
                cuda_ms(kernels, 20) / 2,
                cuda_ms(lambda: continuity_ppm(*args, **tkw), 3) / 2,
                kernels, cuda_ms(wrapped, 20) / 2)
    bargs = args + (x["vr_u"], x["vr_v"])
    ref, out = set_up_bt_cont(*bargs), cc.set_up_bt_cont_cuda(*bargs)
    res.check_mode("K2", "porous", dn, shape, ref._asdict(), out._asdict())
    if timing is not None:
        call = functools.partial(cc.set_up_bt_cont_cuda, *bargs)
        timing[("K2", "porous")] = (
            cuda_ms(call, 20), cuda_ms(lambda: set_up_bt_cont(*bargs), 3),
            call)


def subcycle_case(ni, nj, nk, dtype, curve, seed=5, reentrant_y=False,
                  period=1, nstep=None, reentrant_x=True, opts=None,
                  obc_dir=None):
    """btstep's set-up on random inputs (as in the JAX package's
    subcycle tests), returning the subcycle's inputs: on the model's
    domain for ``period`` 1 (K3), widened to a halo of 3*period for the
    march (K3m); ``opts``: more BarotropicCfg options (BT_OPTIONS).
    With ``obc_dir`` the segments of ``open_boundaries`` (their data
    written there) open the grid, and (inputs, edge vectors) return."""
    import numpy as np
    import torch
    from mom6_torch.core.barotropic import (BarotropicCfg, set_dtbt,
                                            subcycle_inputs)
    from mom6_torch.core.continuity_ppm import set_up_bt_cont
    d, g, vg = make_grid(ni, nj, nk, dtype, reentrant_y=reentrant_y,
                         reentrant_x=reentrant_x)
    obc = None
    if obc_dir is not None:
        g, obc = open_boundaries(d, g, obc_dir)
    rng = np.random.default_rng(seed)

    def t(a):
        a = d.fill_halos(d.pad(torch.as_tensor(a, dtype=dtype, device=DEV)))
        return a if obc is None else obc.extend(a)

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
                        wide_halo_period=period, **(opts or {}))
    inp = subcycle_inputs(d, g, vg, u, v, eta, h, acc, acc, pbce, u, v,
                          600.0, cfg, taux=0.1 * g.mask2dCu, bt_cont=bc,
                          eta_cor=ecor, uhbt_in=uh0, vhbt_in=vh0, obc=obc)
    if obc is None:
        return inp
    from mom6_torch.core.barotropic import obc_edges
    return inp, obc_edges(obc, inp.consts, vg.g_Earth)


def check_k3(res, ni, nj, nk, dtype, timing=None, key="K3",
             reentrant_x=True, exact=False):
    """K3 against its plain version, linear and curve transports; the
    curve case timed into ``timing[key]``; ``exact`` requires equality
    and prints the band plan (the closed-basin checks)."""
    from mom6_torch.core import barotropic_cuda as bc
    dn = str(dtype).split(".")[-1]
    for curve in (False, True):
        inp = subcycle_case(ni, nj, nk, dtype, curve,
                            reentrant_x=reentrant_x)
        args = inp[:-1]          # K3 takes no exchange period
        d = inp.domain
        _, _, _, ref = bc.subcycle_plain(*args)
        _, _, _, out = bc.subcycle_cuda(*args)
        form = "curve" if curve else "linear"
        walls = "" if reentrant_x else " walled x"
        if exact and inp.eta.is_cuda:
            log(f"  K3 band plan {d.njh}x{d.nih} {dn} {form}: "
                f"{bc_plan(inp)}")
        res.check_all("K3", dn, f"{nk}x{d.njh}x{d.nih}{walls} {form}", ref,
                      out, exact=exact)
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


def check_bt_options(res, ni, nj, nk, dtype):
    """K3 (period 1) and K3m (period 2, walled y) on planes built under
    BT_OPTIONS (the harmonic viscous remnant of BT_STRONG_DRAG, the
    BOUND_BT_CORRECTION-limited eta source) against their plain
    versions, linear and curve transports (the bound needs the
    curves)."""
    from mom6_torch.core import barotropic_cuda as bc
    dn = str(dtype).split(".")[-1]
    for curve in (False, True):
        form = "curve" if curve else "linear"
        for key, period, plain, kern in (
                ("K3", 1, bc.subcycle_plain, bc.subcycle_cuda),
                ("K3m", 2, bc.subcycle_march_plain,
                 bc.subcycle_march_cuda)):
            inp = subcycle_case(ni, nj, nk, dtype, curve, period=period,
                                opts=BT_OPTIONS)
            args = inp[:-1] if period == 1 else inp
            _, _, _, ref = plain(*args)
            _, _, _, out = kern(*args)
            d = inp.domain
            res.check_all(key, dn, f"{d.njh}x{d.nih} BT_STRONG_DRAG + "
                          f"BOUND_BT_CORRECTION {form}", ref, out, H=d.halo)


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


def open_boundaries(d, g, tmp, t=3000.0):
    """The segments of configs.BENCH_CONFIG_OBC on ``d`` (walls or not):
    whole W and E edges, the S strip over the middle half of the edge,
    the E data of ``configs.write_obc_data`` (seed 2, in ``tmp``) at the
    model time ``t``; returns (the grid with its masks opened, obc)."""
    from mom6_torch import configs
    from mom6_torch.framework.config import ParamFile
    from mom6_torch.obc.open_boundary import (build_obc_data_interp,
                                              build_open_boundaries,
                                              open_grid_masks)
    configs.write_obc_data(str(tmp), d.ni, d.nj, seed=2)
    text = "".join(ln + "\n" for ln in configs.OBC_LINES.splitlines()
                   if ln.startswith(("OBC_NUMBER", "OBC_SEGMENT")))
    pf = ParamFile(text=text + configs.obc_strip(d.ni)
                   + f"INPUTDIR = {tmp}\n")
    obc = build_open_boundaries(pf, d, str(tmp), device=g.dxT.device,
                                dtype=g.dxT.dtype)
    obc = build_obc_data_interp(pf, d, obc, str(tmp))(obc, g, None, t)
    return open_grid_masks(g, obc), obc


def check_k3_obc(res, ni, nj, nk, dtype, tmp, timing=None):
    """K3's open-face instance against its plain version, required equal
    on the whole padded array, linear transports; timed into
    ``timing["K3o"]``."""
    import torch
    from mom6_torch.core import barotropic_cuda as bc
    dn = str(dtype).split(".")[-1]
    inp, edges = subcycle_case(ni, nj, nk, dtype, False, reentrant_x=False,
                               obc_dir=tmp)
    args = inp[:-1]
    d = inp.domain
    before = bc.subcycle_cuda.obc_launches
    _, _, _, ref = bc.subcycle_plain(*args, obc=edges)
    _, _, _, out = bc.subcycle_cuda(*args, obc=edges)
    if inp.eta.is_cuda and bc.subcycle_cuda.obc_launches != before + 1:
        raise AssertionError("K3 with open faces did not launch its "
                             "open-face instance")
    if inp.eta.is_cuda:
        log(f"  K3o band plan {d.njh}x{d.nih} {dn}: {bc_plan(inp)}")
    res.check_all("K3o", dn, f"{nk}x{d.njh}x{d.nih} open W/E, S strip",
                  ref, out, H=0, exact=True)
    # the open faces act: the closed instance gives other sums
    _, _, _, closed = bc.subcycle_plain(*args)
    if torch.equal(closed["eta"], ref["eta"]):
        raise AssertionError("K3o: the open faces changed nothing")
    if timing is not None:
        timing["K3o"] = (
            cuda_ms(lambda: bc.subcycle_cuda(*args, obc=edges), 10),
            cuda_ms(lambda: bc.subcycle_plain(*args, obc=edges), 2),
            (inp, edges))


def check_k1_obc(res, ni, nj, nk, dtype, tmp):
    """K1 (both orders) against its plain version, required equal, on
    the open grid with every input's halos filled and extended through
    the open edges, as the split steppers fill them under OBC."""
    from mom6_torch.core import continuity_cuda as cc
    from mom6_torch.core.continuity_ppm import ContinuityCfg, continuity_ppm
    d, g, vg, x = continuity_inputs(ni, nj, nk, dtype, seed=4,
                                    reentrant_x=False)
    g, obc = open_boundaries(d, g, tmp)
    x = obc.extend(d.fill_halos(x))
    dn = str(dtype).split(".")[-1]
    for x_first in (True, False):
        args = (g, vg, x["u"], x["v"], x["h"], 600.0, ContinuityCfg())
        ref = continuity_ppm(*args, uhbt=x["uhbt"], vhbt=x["vhbt"],
                             visc_rem_u=x["vr_u"], visc_rem_v=x["vr_v"],
                             x_first=x_first)
        out = cc.continuity_ppm_cuda(*args, x["uhbt"], x["vhbt"], x["vr_u"],
                                     x["vr_v"], x_first=x_first)
        for name in ("h", "uh", "vh", "u_cor", "v_cor"):
            res.check("K1", dn, f"{nk}x{d.njh}x{d.nih} OBC-extended "
                      f"x_first={x_first} {name}", getattr(ref, name),
                      getattr(out, name), exact=True)


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
    ``kernel`` (empty when the library was already built), logged and
    returned as {mangled instance name: [its lines]}."""
    current, out = None, {}
    for line in ptxas_log.splitlines():
        if "Function properties for" in line:
            current = line.split("for", 1)[1].strip()
        elif current and kernel in current and (
                "spill" in line or "Used" in line):
            text = line.split(':', 1)[-1].strip()
            log(f"  ptxas {current}: {text}")
            out.setdefault(current, []).append(text)
    return out


def subcycle_resources(found):
    """K3/K3m's instances by (type, one-tile band, open faces) from the
    mangled names of ``log_resources``."""
    import re
    out = {}
    for name, lines in found.items():
        m = re.search(r"subcycle_kernelI([fd])Lb([01])ELb([01])E", name)
        if m:
            key = (f"{'float' if m.group(1) == 'f' else 'double'}, "
                   f"{'one tile' if m.group(2) == '1' else 'tiled'}, "
                   f"{'open faces' if m.group(3) == '1' else 'closed'}")
            out[key] = "; ".join(lines)
    return out


def bc_plan(inp):
    """A short description of the band plan of ``inp``'s subcycle."""
    from mom6_torch.core import barotropic_cuda as bc
    p = bc.launch_plan(inp.eta, inp.use_curve)
    return (f"{p.blocks} blocks x {p.points_per_block} points, {p.tiles} "
            f"tile{'s' if p.tiles > 1 else ''}, {p.placement} transport "
            "constants")


# a torch.profiler trace taken after one that covered whole steps has
# come back missing some or all kernel events (0 or 8 of 10 sweeps, then
# 10 of 10 in the next trace of the same calls): a count that disagrees
# is traced again, up to this many traces
TRACE_ATTEMPTS = 3
SPIN_CYCLES = 100000           # ~0.05 ms at the H100's clock


def traced_kernels(fn, reps=1, before=None):
    """The device kernels ``reps`` calls of ``fn`` launch, as
    torch.profiler traces them: [(name, microseconds)].  The profiler
    first runs one warm-up round of the same calls, whose events it
    drops; ``before`` runs between the two rounds.  Each round's calls
    sit between two short spin kernels (``torch.cuda._sleep``), left out
    of the result: a trace that drops the first or the last kernel
    event of its window (seen on the card after long runs, every retry
    4 of 5 K2 calls) drops a spin kernel instead."""
    import os
    import tempfile
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        # the active round's trace is written when that round ends
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=lambda p: p.export_chrome_trace(path)
                     ) as prof:
            for cycle in range(2):
                if cycle and before is not None:
                    before()
                torch.cuda._sleep(SPIN_CYCLES)
                for _ in range(reps):
                    fn()
                torch.cuda._sleep(SPIN_CYCLES)
                torch.cuda.synchronize()
                prof.step()
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return [(e["name"], e["dur"]) for e in events
            if e.get("ph") == "X" and e.get("cat") == "kernel"
            and "spin_kernel" not in e["name"]]


def profiled_kernels(fn, kernel, reps=1, expect=None):
    """(the traced device kernels whose name holds ``kernel``, all of
    them, mean device milliseconds a call of the ``kernel`` ones); with
    ``expect`` (the count of ``kernel`` kernels wanted) a trace that
    has another count is taken again (TRACE_ATTEMPTS)."""
    for attempt in range(1, TRACE_ATTEMPTS + 1):
        kern = traced_kernels(fn, reps)
        mine = [d for name, d in kern if kernel in name]
        if expect is None or len(mine) == expect:
            break
        log(f"  trace {attempt}: {len(mine)} {kernel} kernels of "
            f"{expect}: traced again")
    return len(mine), len(kern), sum(mine) / 1e3 / reps


def trace_kernels(timing, wrappers):
    """{kernel: (kernels traced of its own, device kernels in all, mean
    device ms a call)} for K1, K2, K3, K3m and K3o: PROFILE_REPS wrapper
    calls on the main path's inputs of ``timing`` in one torch.profiler
    trace each, required to trace one device kernel per launch unit (and
    for K1 and K2 nothing else).  Taken right after the kernel checks: a
    trace taken after the long phases loses kernel events (ROADMAP.md
    Queue 3)."""
    import torch
    from mom6_torch.core import barotropic_cuda
    out = {}
    for k in KERNELS:
        inp = timing[k][2]
        name, per_call = PROFILED[k]
        call = inp if callable(inp) else functools.partial(
            wrappers[k], *(inp[:-1] if k == "K3" else inp))
        units_traced = PROFILE_REPS * per_call
        n_prof, n_all, dev_ms = profiled_kernels(call, name, PROFILE_REPS,
                                                 units_traced)
        if n_prof != units_traced or (k not in DEVICE_COUNTED
                                      and n_all != n_prof):
            raise AssertionError(f"{k}: torch.profiler traced {n_prof} "
                                 f"{name} kernels ({n_all} device kernels "
                                 f"in all) in {units_traced} launches, "
                                 "expected one each")
        out[k] = (n_prof, n_all, dev_ms)
    inp, edges = timing["K3o"][2]
    call = functools.partial(barotropic_cuda.subcycle_cuda, *inp[:-1],
                             obc=edges)
    n_prof, n_all, dev_ms = profiled_kernels(call, "subcycle_kernel",
                                             PROFILE_REPS, PROFILE_REPS)
    if n_prof != PROFILE_REPS:
        raise AssertionError(f"K3o: torch.profiler traced {n_prof} "
                             f"subcycle kernels in {PROFILE_REPS} launches")
    out["K3o"] = (n_prof, n_all, dev_ms)
    torch.cuda.synchronize()
    return out


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
        # u, h, visc_rem, hbt + 6 grid planes in; h, flux, u_cor, du out
        "K1": ((6 * nk) * P + 8 * P, OPS_K1 * nk * P),
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


def run_full(ni, nj, nk, dtype, device, nsteps, seed, regridding,
             dynamics="rk2", period=2, tides=True, with_carry=False,
             extra=""):
    """``nsteps`` full steps from the configuration's initial state plus
    the seeded perturbation of ``entry.build_full``: the configuration
    starts at rest and horizontally uniform, where a comparison of the
    first steps' v and eta would compare roundoff.  ``tides=False``
    drops the split stepper's tidal forcing from the built model;
    ``with_carry`` returns the step closure's carry fourth; ``extra``:
    more MOM_input lines."""
    from mom6_torch import entry
    m = entry.build_full(ni, nj, nk, seed=seed, regridding=regridding,
                         dynamics=dynamics, wide_halo_period=period,
                         extra=extra, device=device, dtype=dtype)
    if not tides:
        m.cfg = dataclasses.replace(m.cfg, split_cfg=dataclasses.replace(
            m.cfg.split_cfg, tides_fn=None))
    step = m.step_fn()
    st, sp, tr = m.state, m.split, m.tracers
    for n in range(nsteps):
        st, sp, tr = step(st, sp, tr, n)
    if with_carry:
        return st, sp, tr, step.carry()
    return st, sp, tr


def fp32_departure(n):
    """The float32 run on the card against the float64 run, ``n`` steps
    from the same seeded state at 32x32x6: B1 with its tides on and
    off (the tidal geopotential's gradient at depth is quantized in
    float32, ROADMAP.md Queue 3), and bench.py's CONFIG beside them."""
    import torch
    for label, dyn, tides in (("B1, tides on", "b1", True),
                              ("B1, tides off", "b1", False),
                              ("bench.py's CONFIG", "rk2", True)):
        (a, a_sp, _), (b, b_sp, _) = (
            run_full(*SMALL_FULL, dtype, DEV, n, seed=3, regridding=True,
                     dynamics=dyn, tides=tides)
            for dtype in (torch.float64, torch.float32))
        errs = {name: rel_err(getattr(a, name), getattr(b, name))[0]
                for name in ("h", "u", "v", "T")}
        errs["eta"] = rel_err(a_sp.eta, b_sp.eta)[0]
        log(f"  {label}: fp32 against fp64 after {n} steps, max rel err "
            + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))


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
                peak_bytes=peak, state=st,
                by_kind={k: sum(v) / len(v) for k, v in by_kind.items()
                         if v})


def read_counts(wrappers):
    """Every wrapper's launches, the untargeted and the porous K1 sweeps
    as K1u and K1p, and K3's open-face launches as K3o."""
    from mom6_torch.core import barotropic_cuda as bc
    from mom6_torch.core import continuity_cuda as cc
    counts = {k: w.launches for k, w in wrappers.items()}
    counts["K1u"] = cc.continuity_ppm_cuda.untargeted_launches
    counts["K1p"] = cc.continuity_ppm_cuda.porous_launches
    counts["K3o"] = bc.subcycle_cuda.obc_launches
    return counts


def run_new_timed(dynamics, wrappers, shape, extra=None):
    """build_full(dynamics=...) at full width in fp32: 2 warm-up steps,
    then NEW_STEPS timed steps with every launch counter zeroed just
    before and read just after (PER_STEP asserted), ms/step by kind of
    step, the peak of max_memory_allocated, finite fields; then 2 more
    steps under torch.profiler, whose device kernels must be one per
    launch.  ``extra(m, state, fstep, n_done)`` runs after those and
    returns more entries for the result."""
    import torch
    from mom6_torch import entry
    m = entry.build_full(*MAIN, dynamics=dynamics, device=DEV,
                         dtype=torch.float32)
    full_step = m.step_fn()
    cur = [m.state, m.split, m.tracers]
    n_done = [0]

    def fstep():
        cur[:] = full_step(*cur, n_done[0])
        n_done[0] += 1

    fstep.carry = full_step.carry
    fstep.offline_fields = full_step.offline_fields
    for _ in range(2):
        fstep()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(wrappers)
    events = [torch.cuda.Event(enable_timing=True)
              for _ in range(NEW_STEPS + 1)]
    kinds = []
    events[0].record()
    for i in range(NEW_STEPS):
        kinds.append("thermo" if (n_done[0] + 1) % m.cfg.n_dyn_per_therm
                     == 0 else "dynamics-only")
        fstep()
        events[i + 1].record()
    torch.cuda.synchronize()
    counts = read_counts(wrappers)
    device = {k: wrappers[k].device_launches for k in DEVICE_COUNTED}
    peak = torch.cuda.max_memory_allocated()
    expect = {k: n * NEW_STEPS for k, n in PER_STEP[dynamics].items()}
    if counts != expect:
        raise AssertionError(f"{dynamics} launch counts {counts}, "
                             f"expected {expect}")
    check_device_launches(dynamics, device, counts)
    st, sp, tr = cur
    fields = [(k, f) for k, f in (("h", st.h), ("u", st.u), ("v", st.v),
                                  ("T", st.T), ("S", st.S))
              if f is not None] + sorted(tr.items())
    if sp is not None:
        fields += [(f.name, getattr(sp, f.name))
                   for f in dataclasses.fields(sp)]
    check_finite(fields, shape)
    per = [events[i].elapsed_time(events[i + 1]) for i in range(NEW_STEPS)]
    by_kind = {k: [t for t, kk in zip(per, kinds) if kk == k]
               for k in ("thermo", "dynamics-only")}
    ms_full = sum(per) / NEW_STEPS
    log(f"  {NEW_STEPS} steps (dt {m.dt:g} s, {m.cfg.n_dyn_per_therm} "
        f"steps a thermodynamic step): {ms_full:.3f} ms/step mean (CUDA "
        "events), " + ", ".join(f"{k} {sum(v) / len(v):.3f} ms/step over "
                                f"{len(v)}" for k, v in by_kind.items()
                                if v)
        + f"; {ms_full / (m.dt / 600.0):.3f} ms per 600 s of model time; "
        f"launches {counts}; peak memory {peak} B ({peak / 2**30:.3f} GiB,"
        " max_memory_allocated)")
    log(f"  h range [{float(m.domain.interior(st.h).min()):.3f}, "
        f"{float(m.domain.interior(st.h).max()):.3f}] m, max |u| "
        f"{float(st.u.abs().max()):.4f} m/s"
        + ("" if sp is None else
           f", max |eta| {float(sp.eta.abs().max()):.4f} m"))
    # one device kernel per launch over 2 traced steps (after 2 warm-up
    # steps under the profiler)
    one_kernel_per_launch(dynamics, lambda: (fstep(), fstep()), wrappers,
                          "2 steps")
    more = {} if extra is None else extra(m, cur, fstep, n_done)
    return dict(ms_step=ms_full, by_kind={k: sum(v) / len(v)
                                          for k, v in by_kind.items() if v},
                launches=counts, peak_bytes=peak, **more)


def one_kernel_per_launch(label, fn, wrappers, what):
    """Trace ``fn`` (after one warm-up round of it under the profiler)
    and require one device kernel per launch of K1, K2 and the K3/K3m
    subcycle: a trace that has another count is taken again
    (TRACE_ATTEMPTS)."""
    for attempt in range(1, TRACE_ATTEMPTS + 1):
        kern = traced_kernels(fn, before=lambda: zero_counts(wrappers))
        counts = read_counts(wrappers)
        want = {"sweep_kernel": counts["K1"],
                "bt_cont_kernel": counts["K2"],
                "subcycle_kernel": wrappers["K3"].device_launches
                + wrappers["K3m"].device_launches}
        got = {k: sum(k in name for name, _ in kern) for k in want}
        if got == want:
            break
        log(f"  trace {attempt}: device kernels {got} for launches "
            f"{want}: traced again")
    if got != want:
        raise AssertionError(f"{label}: torch.profiler traced {got} "
                             f"device kernels for launches {want}")
    log(f"  torch.profiler over {what}: device kernels {got}, one per "
        "launch")


def obc_extra(m, cur, fstep, n_done):
    """For BENCH_CONFIG_OBC: each dye on the compute domain within
    [0, 1], to 1e-5 (float32 rounding of the advected unit values)."""
    _, _, tr = cur
    ranges = {}
    for k in sorted(tr):
        if not k.startswith("dye"):
            continue
        f = m.domain.interior(tr[k])
        lo, hi = float(f.min()), float(f.max())
        ranges[k] = (lo, hi)
        if not (-1e-5 <= lo and hi <= 1.0 + 1e-5):
            raise AssertionError(f"{k} range [{lo!r}, {hi!r}] leaves "
                                 "[0, 1]")
    log("  dyes on the compute domain: " + ", ".join(
        f"{k} [{lo:.3e}, {hi:.6f}]" for k, (lo, hi) in ranges.items()))
    return dict(dye_ranges=ranges)


def stoch_extra(m, cur, fstep, n_done):
    """For BENCH_CONFIG_STOCH: the pattern update (step_pattern, the
    gridded generator and the smoother) and SKEB (apply_skeb) alone at
    full width (CUDA events), then one thermodynamic and one
    dynamics-only step under the profiler with profile_step's ranges:
    the device time and kernels of each stochastic piece, of the Stanley
    terms under STOCH_EOS and of GME, and the step's idle share."""
    import torch
    from mom6_torch import profile_step
    from mom6_torch.param.stochastic import stochastics as sto
    d, g, cfg, seed = m.domain, m.grid, m.cfg.sppt, m.cfg.sppt_seed
    st = cur[0]
    pat = sto.init_pattern(d, cfg, seed, dtype=st.h.dtype, device=DEV)
    pat_ms = cuda_ms(lambda: sto.step_pattern(d, cfg, pat, seed, 5), 10)
    uf, vf = d.fill_vector_halos(st.u, st.v, width=1)
    skeb_ms = cuda_ms(lambda: sto.apply_skeb(d, g, cfg, uf, vf, pat, m.dt),
                      10)
    p = sto.step_pattern(d, cfg, pat, seed, 5)
    log(f"  step_pattern alone {pat_ms:.4f} ms, apply_skeb alone "
        f"{skeb_ms:.4f} ms (CUDA events, 10 calls); the pattern after a "
        f"step: range [{float(d.interior(p).min()):.4f}, "
        f"{float(d.interior(p).max()):.4f}], rms "
        f"{float(d.interior(p).pow(2).mean().sqrt()):.4f}")
    if not bool(torch.isfinite(p).all()):
        raise AssertionError("stoch: the pattern is not finite")
    out = dict(step_pattern_ms=pat_ms, apply_skeb_ms=skeb_ms, profiled={})
    targets = profile_step.slice2_targets("stoch")
    for kind in ("thermo", "dynamics-only"):
        while ((n_done[0] + 1) % m.cfg.n_dyn_per_therm == 0) \
                != (kind == "thermo"):
            fstep()
        summary = profile_step._profile(fstep, targets, f"stoch {kind}",
                                        None)
        ph = summary.get("phases", {})
        got = {k: ph[k] for k in STOCH_PHASES if k in ph}
        log(f"  profiled {kind} step: device busy "
            f"{summary.get('device_busy_ms', 0.0):.3f} ms, idle share "
            f"{summary.get('idle_share_profiled', float('nan')):.1%}, "
            f"{summary.get('kernels', 0)} kernels; "
            + "; ".join(f"{k} x{v['calls']}: {v['kernels']} kernels "
                        f"{v['device_ms']:.4f} ms" for k, v in got.items()))
        out["profiled"][kind] = dict(
            device_busy_ms=summary.get("device_busy_ms"),
            idle_share=summary.get("idle_share_profiled"),
            kernels=summary.get("kernels"), phases=got)
    thermo = out["profiled"]["thermo"]["phases"]
    for k in ("pattern/step_pattern", "apply_skeb", "apply_sppt"):
        if k not in thermo:
            raise AssertionError(f"stoch: no {k} in a thermodynamic step")
    dyn = out["profiled"]["dynamics-only"]["phases"]
    for k in ("dynamics/horizontal_viscosity/gme_stress",
              "dynamics/stoch_eos_multiplier",
              "dynamics/pressure_force/calc_varT"):
        if k not in dyn:
            raise AssertionError(f"stoch: no {k} in a dynamics step")
    return out


def column_extra(m, cur, fstep, n_done):
    """For BENCH_CONFIG_B3 and BENCH_CONFIG_BML: the frazil field finite
    and non-negative, then one thermodynamic step under the profiler
    with profile_step's ranges: the device time and kernels of
    set_diffusivity, kappa-shear, ePBL, full convection, frazil, the
    bulk mixed layer, entrainment and regularization, and the step's
    idle share."""
    from mom6_torch import profile_step
    st = cur[0]
    fz = m.domain.interior(st.frazil)
    check_finite([("frazil", st.frazil)], st.h.shape)
    if float(fz.min()) < 0.0:
        raise AssertionError("frazil is negative")
    while (n_done[0] + 1) % m.cfg.n_dyn_per_therm != 0:
        fstep()
    summary = profile_step._profile(fstep, profile_step.slice2_targets("b3"),
                                    "column thermo", None)
    ph = summary.get("phases", {})
    got = {k: ph[k] for k in COLUMN_PHASES if k in ph}
    log(f"  profiled thermodynamic step: device busy "
        f"{summary.get('device_busy_ms', 0.0):.3f} ms, idle share "
        f"{summary.get('idle_share_profiled', float('nan')):.1%}, "
        f"{summary.get('kernels', 0)} kernels; "
        + "; ".join(f"{k} x{v['calls']}: {v['kernels']} kernels "
                    f"{v['device_ms']:.4f} ms device, {v['host_ms']:.3f} "
                    "ms host" for k, v in got.items()))
    want = ("diabatic/energetic_pbl", "diabatic/set_diffusivity/kappa_shear",
            "diabatic/full_convection") if m.cfg.diabatic.use_epbl else (
        "diabatic/bulk_mixed_layer", "diabatic/entrainment_diffusive",
        "diabatic/regularize_layers")
    for k in want + ("diabatic/make_frazil",):
        if k not in got:
            raise AssertionError(f"no {k} in a thermodynamic step")
    log(f"  frazil on the compute domain: max {float(fz.max())!r} J m-2; "
        f"max |u| {float(st.u.abs().max()):.4f} m/s")
    return dict(frazil_max=float(fz.max()), profiled_thermo=dict(
        device_busy_ms=summary.get("device_busy_ms"),
        idle_share=summary.get("idle_share_profiled"),
        kernels=summary.get("kernels"), phases=got))


def lateral_extra(m, cur, fstep, n_done):
    """For BENCH_CONFIG_B4 and BENCH_CONFIG_B4V: MEKE's energy and the
    internal-tide energy (where the text has them) finite and
    non-negative on the compute domain, then one thermodynamic step under
    the profiler with profile_step's ranges: the device time, host time
    and kernels of VarMix, MEKE, GM, the interface filter, neutral and
    boundary diffusion, the epipycnal diffusion and the internal tides
    with their wave speeds, and the step's idle share."""
    from mom6_torch import profile_step
    st = cur[0]
    dyn = "b4" if m.cfg.use_meke else "b4v"
    found = {}
    for name, f in (("meke", st.meke), ("int_tide_en",
                                        fstep.carry().get("iten"))):
        if f is None:
            continue
        check_finite([(name, f)], st.h.shape)
        fi = m.domain.interior(f)
        if float(fi.min()) < 0.0:
            raise AssertionError(f"{name} is negative")
        found[name + "_max"] = float(fi.max())
    if dyn == "b4" and len(found) != 2:
        raise AssertionError(f"b4: MEKE or internal-tide energy missing "
                             f"({sorted(found)})")
    while (n_done[0] + 1) % m.cfg.n_dyn_per_therm != 0:
        fstep()
    summary = profile_step._profile(fstep, profile_step.slice2_targets(dyn),
                                    "lateral thermo", None)
    ph = summary.get("phases", {})
    got = {k: ph[k] for k in LATERAL_PHASES if k in ph}
    log(f"  profiled thermodynamic step: device busy "
        f"{summary.get('device_busy_ms', 0.0):.3f} ms, idle share "
        f"{summary.get('idle_share_profiled', float('nan')):.1%}, "
        f"{summary.get('kernels', 0)} kernels; "
        + "; ".join(f"{k} x{v['calls']}: {v['kernels']} kernels "
                    f"{v['device_ms']:.4f} ms device, {v['host_ms']:.3f} "
                    "ms host" for k, v in got.items()))
    for k in LATERAL_NEEDED[dyn]:
        if k not in got:
            raise AssertionError(f"{dyn}: no {k} in a thermodynamic step")
    log("  " + "".join(f"{k} {v!r}, " for k, v in found.items())
        + f"max |u| {float(st.u.abs().max()):.4f} m/s")
    return dict(found, profiled_thermo=dict(
        device_busy_ms=summary.get("device_busy_ms"),
        idle_share=summary.get("idle_share_profiled"),
        kernels=summary.get("kernels"), phases=got))


def hybrid_extra(m, cur, fstep, n_done):
    """For BENCH_CONFIG_HYBGEN and BENCH_CONFIG_ADAPT: one regrid
    (``build_grid`` on the current state) and one density call of the
    text's equation of state alone, each timed with CUDA events and the
    host clock and traced for its kernels; then one thermodynamic step
    under the profiler with profile_step's ranges: the device time, host
    time and kernels of the ALE call, the regrid, the remaps and the
    polynomial EOS, and the step's idle share."""
    import torch
    from mom6_torch import profile_step
    from mom6_torch.ale.regridding import build_grid
    st = cur[0]
    dyn = "hybgen" if m.cfg.ale.regrid.mode.upper() == "HYBGEN" else "adapt"
    vg, g = m.vgrid, m.grid

    def regrid():
        return build_grid(m.cfg.ale.regrid, st.h, g.bathyT, st.T, st.S,
                          m.eos, rlay=vg.Rlay, rho0=vg.Rho0, g=vg.g_Earth,
                          mask2dT=g.mask2dT)

    p = torch.full_like(st.T, 2.0e7)

    def density():
        return m.eos.density(st.T, st.S, p)

    out = {}
    for name, fn in (("regrid", regrid), ("eos_density", density)):
        if not bool(torch.isfinite(m.domain.interior(fn())).all()):
            raise AssertionError(f"{dyn} {name} is not finite")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ms = cuda_ms(fn, 3)
        host = (time.perf_counter() - t0) / 4 * 1e3
        summary = profile_step._profile(fn, (), f"{dyn} {name}", None)
        out[name] = dict(ms=ms, host_ms=host,
                         kernels=summary.get("kernels"),
                         device_busy_ms=summary.get("device_busy_ms"))
        log(f"  {dyn} {name} alone: {ms:.3f} ms (CUDA events), ~{host:.3f} "
            f"ms a call on the host clock, {summary.get('kernels')} device "
            f"kernels, {summary.get('device_busy_ms', 0.0):.3f} ms device "
            "busy (profiler)")
    while (n_done[0] + 1) % m.cfg.n_dyn_per_therm != 0:
        fstep()
    summary = profile_step._profile(fstep, profile_step.slice2_targets(dyn),
                                    f"{dyn} thermo", None)
    ph = summary.get("phases", {})
    got = {k: ph[k] for k in HYBRID_PHASES if k in ph}
    log(f"  profiled thermodynamic step: device busy "
        f"{summary.get('device_busy_ms', 0.0):.3f} ms, idle share "
        f"{summary.get('idle_share_profiled', float('nan')):.1%}, "
        f"{summary.get('kernels', 0)} kernels; "
        + "; ".join(f"{k} x{v['calls']}: {v['kernels']} kernels "
                    f"{v['device_ms']:.4f} ms device, {v['host_ms']:.3f} "
                    "ms host" for k, v in got.items()))
    for k in HYBRID_NEEDED[dyn]:
        if k not in got:
            raise AssertionError(f"{dyn}: no {k} in a thermodynamic step")
    return dict(out, profiled_thermo=dict(
        device_busy_ms=summary.get("device_busy_ms"),
        idle_share=summary.get("idle_share_profiled"),
        kernels=summary.get("kernels"), phases=got))


def _eos_methods(e, T, S, p):
    """Every EOS method's outputs, by name."""
    out = {"density": e.density(T, S, p),
           "density rho_ref": e.density(T, S, p, rho_ref=1035.0),
           "spec_vol": e.spec_vol(T, S, p),
           "spec_vol spv_ref": e.spec_vol(T, S, p, spv_ref=1.0 / 1035.0),
           "compressibility": e.compressibility(T, S, p)}
    out.update(zip(("drho_dT", "drho_dS"), e.density_derivs(T, S, p)))
    out.update(zip(("d2_SS", "d2_ST", "d2_TT", "d2_SP", "d2_TP"),
                   e.density_second_derivs(T, S, p)))
    return out


def check_eos_forms():
    """Every EQN_OF_STATE form's every method on the card against the CPU
    in fp64, on seeded T in [-2, 30] degC, S in [30, 38] and p in [0, 6e7]
    Pa at 25x66x66: 1e-12 relative to each field's maximum; 5e-12 for
    d2rho/dS2 of the polynomial forms, whose matrix product sums in
    another order on the card (the CPU tests hold the JAX package's to
    the same)."""
    import numpy as np
    import torch
    from mom6_torch.eos import make_eos
    rng = np.random.default_rng(21)
    shape = (25, 66, 66)
    x = [rng.uniform(-2.0, 30.0, shape), rng.uniform(30.0, 38.0, shape),
         rng.uniform(0.0, 6e7, shape)]
    worst = 0.0
    for form in EOS_FORMS:
        e = make_eos(form)
        cpu = _eos_methods(e, *(torch.tensor(a) for a in x))
        card = _eos_methods(e, *(torch.tensor(a, device=DEV) for a in x))
        errs = {}
        for k, a in cpu.items():
            rel, _ = rel_err(a, card[k].cpu(), H=0)
            errs[k] = rel
            tol = 5e-12 if (k == "d2_SS" and form in (
                "ROQUET_RHO", "ROQUET_SPV", "TEOS10")) else 1e-12
            if not rel <= tol:
                raise AssertionError(f"EOS {form} {k}: card vs cpu {rel:.3e}"
                                     f" > {tol:.0e}")
        worst = max(worst, max(errs.values()))
        log(f"  EOS {form}: card vs cpu max rel err "
            + ", ".join(f"{k} {v:.1e}" for k, v in errs.items()))
    return worst


def check_hybrid_modules():
    """hybgen_regrid, hybgen_unmix (with a tracer), the ADAPTIVE
    coordinate (with and without ADAPT_DO_MIN_DEPTH, on a land mask) and
    the three hybgen remap schemes (the remapped cells' contents) on
    seeded 25-layer columns at 25x66x66 in fp64, on the card against the
    CPU, under WRIGHT: 1e-12 relative to each field's maximum, ADAPTIVE
    1e-11."""
    import numpy as np
    import torch
    from mom6_torch.ale import hybgen_regrid as hr, hybgen_unmix as hu
    from mom6_torch.ale import regridding as rg, remapping as rm
    from mom6_torch.eos import make_eos
    nk, nj, ni = 25, 66, 66
    rng = np.random.default_rng(22)
    h = rng.uniform(0.0, 300.0, (nk, nj, ni))
    h[:, :4, :4] *= 1e-3
    rcv = (np.sort(1025.0 + rng.uniform(-1.0, 5.0, h.shape), axis=0)
           + rng.normal(0.0, 0.3, h.shape))
    tgt = np.sort(1025.0 + rng.uniform(0.0, 4.0, nk))
    depth = h.sum(0) * rng.uniform(0.7, 1.3, (nj, ni))
    T = (np.sort(rng.uniform(2.0, 20.0, h.shape), axis=0)[::-1]
         + rng.normal(0.0, 1.0, h.shape))
    S = 35.0 + rng.normal(0.0, 0.5, h.shape)
    age = rng.uniform(0.0, 10.0, h.shape)
    mask = (rng.random((nj, ni)) > 0.2).astype(float)
    w = rng.uniform(0.0, 50.0, h.shape)
    h_dst = w / w.sum(0) * h.sum(0)
    eos = make_eos("WRIGHT")
    cfg = hr.HybgenRegridCfg(dp0k=tuple(rng.uniform(5.0, 50.0, nk)),
                             ds0k=tuple(rng.uniform(1.0, 5.0, nk)),
                             nsigma=3, qhybrlx=0.5)
    rlay = np.sort(eos.density(torch.tensor(T.mean((1, 2))),
                               torch.tensor(S.mean((1, 2))), 2e7).numpy())

    def cases(dev):
        def t(a):
            return torch.tensor(np.ascontiguousarray(a), device=dev)
        out = {"hybgen_regrid": hr.hybgen_regrid(cfg, t(h), t(rcv), t(tgt),
                                                 t(depth))}
        hu_out = hu.hybgen_unmix(t(h), t(T), t(S), {"age": t(age)}, eos,
                                 t(rlay), hu.HybgenUnmixCfg(hybiso=0.5))
        out.update({f"hybgen_unmix {k}": v for k, v in
                    zip(("h", "T", "S"), hu_out[:3])},
                   **{"hybgen_unmix age": hu_out[3]["age"]})
        for do_min in (False, True):
            out[f"adaptive do_min={do_min}"] = rg.build_grid(
                rg.RegridCfg(mode="ADAPTIVE", adapt_do_min=do_min,
                             min_thickness=0.5), t(h) + 1.0,
                t(h.sum(0) + nk), t(T), t(S), eos, mask2dT=t(mask))
        for scheme in ("PLM_HYBGEN", "PPM_HYBGEN", "WENO_HYBGEN"):
            # the cells' contents h u: a mean is a difference of column
            # integrals over its thickness, and the card sums the pair
            # space in another order (a thin cell's mean parts by 7.8e-12
            # on an H100)
            out[f"{scheme} contents"] = t(h_dst) * rm.remap_column_means(
                t(h), t(T), t(h_dst), rm.RemapCfg(scheme=scheme))
        # the means themselves, printed: a thin cell's mean parts by
        # 7.8e-12 on an H100; of these only PPM_H4 takes the boundary
        # cubic of its edges
        for scheme in ("PLM_HYBGEN", "PPM_HYBGEN", "WENO_HYBGEN", "PPM_H4"):
            out[f"{scheme} means"] = rm.remap_column_means(
                t(h), t(T), t(h_dst), rm.RemapCfg(scheme=scheme))
        return out

    cpu, card = cases("cpu"), cases(DEV)
    errs = {}
    for k, a in cpu.items():
        rel, _ = rel_err(a, card[k].cpu(), H=0)
        errs[k] = rel
        if k.endswith(" means"):
            continue
        # ADAPTIVE's column sums (torch.sum) take another order on the
        # card, and its implicit grid diffusion, with diffusivities of
        # ADAPT_TIME_RATIO nk^2 depth, amplifies that last bit (1.5e-12
        # on an H100)
        tol = 1e-11 if k.startswith("adaptive") else 1e-12
        if not rel <= tol:
            raise AssertionError(f"{k}: card vs cpu {rel:.3e} > {tol:.0e}")
    log("  hybrid modules card vs cpu max rel err "
        + ", ".join(f"{k} {v:.1e}" for k, v in errs.items())
        + " (the means printed, not checked)")
    return max(v for k, v in errs.items() if not k.endswith(" means"))


def run_text(text, ni, nj, nk, dtype, device, nsteps, seed, tmp):
    """``nsteps`` steps of the configuration ``text`` (INPUTDIR ``tmp``,
    where configs.write_obc_data writes the E data from seed 0) at
    ``ni`` x ``nj`` x ``nk`` with 10 km cells, from its initial state
    plus the seeded noise of entry.build_full."""
    import numpy as np
    import torch
    from mom6_torch import configs
    from mom6_torch.core.dynamics_split_rk2 import init_split_state
    from mom6_torch.framework.config import ParamFile
    from mom6_torch.model import build_model
    configs.write_obc_data(str(tmp), ni, nj, seed=0)
    text += (f"#override NIGLOBAL = {ni}\n#override NJGLOBAL = {nj}\n"
             f"#override NK = {nk}\n#override LENLON = {ni * 10.0}\n"
             f"#override LENLAT = {nj * 10.0}\n" + configs.obc_strip(ni)
             + f"INPUTDIR = {tmp}\n")
    m = build_model(ParamFile(text=text), device=device, dtype=dtype)
    d, g = m.domain, m.grid
    rng = np.random.default_rng(seed)

    def noisy(a, scale, mask=None):
        x = a + torch.as_tensor(scale * rng.standard_normal(tuple(a.shape)),
                                dtype=dtype, device=device)
        return d.fill_halos(x if mask is None else x * mask)

    st = m.state
    st = st.replace(h=noisy(st.h, 2.0),
                    T=None if st.T is None else noisy(st.T, 0.5),
                    u=noisy(st.u, 0.05, g.mask2dCu),
                    v=noisy(st.v, 0.05, g.mask2dCv))
    sp = init_split_state(d, g, m.vgrid, st,
                          horvisc_cfg=m.cfg.split_cfg.horvisc)
    step = m.step_fn()
    tr = m.tracers
    for n in range(nsteps):
        st, sp, tr = step(st, sp, tr, n)
    return st, sp, tr, step.obc_reservoirs()


def b1_extra(m, cur, fstep, n_done):
    """For BENCH_CONFIG_B1: the SAL call alone and the whole tidal
    geopotential (CUDA events), then one dynamics-only step under the
    profiler with profile_step's ranges: the device time and kernels of
    the porous fractions and of the tidal geopotential a step."""
    from mom6_torch import profile_step
    st, sp, _ = cur
    tides = m.cfg.split_cfg.tides_fn
    sal_ms = cuda_ms(lambda: tides.sal(sp.eta), 20)
    tide_ms = cuda_ms(lambda: tides(sp.eta, 0.0), 20)
    basis = tides.sal.basis
    log(f"  SAL (degree {int(basis.shape[0] ** 0.5) - 1}, basis "
        f"{tuple(basis.shape)}): {sal_ms:.4f} ms a call; the tidal "
        f"geopotential with it {tide_ms:.4f} ms (CUDA events, 20 calls)")
    while (n_done[0] + 1) % m.cfg.n_dyn_per_therm == 0:
        fstep()
    summary = profile_step._profile(fstep, profile_step.slice2_targets("b1"),
                                    "b1 dynamics-only", None)
    ph = summary.get("phases", {})
    frac = ph.get("dynamics/continuity_ppm_cuda/porous_factor",
                  dict(device_ms=0.0, kernels=0, calls=0))
    tid = ph.get("dynamics/tidal_geopotential", dict(device_ms=0.0,
                                                     kernels=0))
    log(f"  porous fractions a dynamics step: {frac['calls']} calls, "
        f"{frac['kernels']} device kernels, {frac['device_ms']:.4f} ms of "
        f"device time; tidal geopotential {tid['kernels']} kernels, "
        f"{tid['device_ms']:.4f} ms (profiled step, "
        f"{summary.get('device_busy_ms', 0.0):.3f} ms busy)")
    if frac["calls"] != 4:
        raise AssertionError(f"B1: {frac['calls']} porous-fraction calls "
                             "in a dynamics step, expected 4")
    return dict(sal_ms=sal_ms, tides_ms=tide_ms,
                fractions_device_ms=frac["device_ms"],
                fractions_kernels=frac["kernels"],
                profiled_busy_ms=summary.get("device_busy_ms"))


def run_ref_tc0(tmp, wrappers):
    """cases/ref_tc0 through the solo driver (DEBUG, DIAG_AS_CHKSUM) in
    fp64 on the card, with every launch counter zeroed just before and
    read just after, and with --cpu: the final state's ocean.stats
    against tests/goldens_ref_cases.json at the tolerances of
    tests/test_ref_cases.py, and the two runs' chksum_debug and
    chksum_diag equal line for line."""
    import shutil
    from mom6_torch.diagnostics.sum_output import collect_stats, stat_sums
    from mom6_torch.drivers import solo
    from mom6_torch.framework.config import ParamFile
    from mom6_torch.model import build_model
    golden = json.loads((ROOT / "tests" / "goldens_ref_cases.json")
                        .read_text())["ref_tc0"]
    case = ROOT / "cases" / "ref_tc0"
    dirs = {}
    for where in ("card", "cpu"):
        d = Path(tmp) / f"ref_tc0_{where}"
        d.mkdir()
        for name in ("MOM_input", "MOM_override"):
            shutil.copy(case / name, d / name)
        dirs[where] = d
    zero_counts(wrappers)
    run = solo.main([str(dirs["card"])])
    n = run["steps"]
    launches = check_driver_launches(
        "ref_tc0", wrappers, {"K1": 6 * n, "K2": 0, "K3": 0, "K3m": 0})
    solo.main([str(dirs["cpu"]), "--cpu"])
    m = build_model(ParamFile(str(case / "MOM_input"),
                              str(case / "MOM_override")),
                    device="cpu", dtype=run["state"].h.dtype)
    s = run["state"]
    s = s.replace(**{k: getattr(s, k).cpu() for k in ("u", "v", "h")})
    st = collect_stats(stat_sums(m.domain, m.grid, m.vgrid, s, m.dt),
                       m.vgrid, n, 0.0)
    checks = (("energy_per_mass", "energy_per_mass", 1e-9, 0.0),
              ("total_mass", "mass", 1e-11, 0.0),
              ("mean_salin", "salt", 0.0, 1e-9),
              ("mean_temp", "temp", 1e-9, 0.0),
              ("max_cfl", "max_cfl", 1e-6, 1e-12),
              ("mean_sea_level", "sea_level", 1e-6, 1e-12))
    if n != golden["nsteps"]:
        raise AssertionError(f"ref_tc0: {n} steps, golden "
                             f"{golden['nsteps']}")
    for field, key, rtol, atol in checks:
        got, want = float(getattr(st, field)), float(golden[key])
        if not abs(got - want) <= atol + rtol * abs(want):
            raise AssertionError(f"ref_tc0 {field}: {got!r} against the "
                                 f"golden {want!r}")
    lines = {}
    for name in ("chksum_debug", "chksum_diag"):
        a, b = ((dirs[w] / name).read_text().splitlines()
                for w in ("card", "cpu"))
        if a != b or len(a) < 6:
            raise AssertionError(f"ref_tc0 {name}: {len(a)} lines on the "
                                 f"card, {len(b)} with --cpu, not equal")
        lines[name] = len(a)
    log(f"  {n} steps: " + ", ".join(
        f"{f} {float(getattr(st, f))!r}" for f, *_ in checks)
        + f" (golden {json.dumps(golden)}); launches {launches}; "
        + ", ".join(f"{k} {v} lines" for k, v in lines.items())
        + ", card and cpu equal line for line")
    return launches


def run_ref_case(tmp, wrappers, case, d=None, per_step=None):
    """cases/ref_tc1, ref_tc2, ref_tc3 or ref_tc4 through the solo driver
    in fp64 on the card for its golden's steps, with every launch counter
    zeroed just before and read just after (``per_step`` a step, by
    default K1 4, K2 1, K3 2): the final state's ocean.stats against
    tests/goldens_ref_cases.json at the tolerances of
    tests/test_ref_cases.py.  ``d``: a case directory made already (with
    the case's input files)."""
    import shutil
    import torch
    from mom6_torch.diagnostics.sum_output import collect_stats, stat_sums
    from mom6_torch.drivers import solo
    from mom6_torch.framework.config import ParamFile
    from mom6_torch.model import build_model
    golden = json.loads((ROOT / "tests" / "goldens_ref_cases.json")
                        .read_text())[case]
    src = ROOT / "cases" / case
    if d is None:
        d = Path(tmp) / f"{case}_card"
        d.mkdir()
        for name in ("MOM_input", "MOM_override"):
            shutil.copy(src / name, d / name)
    m = build_model(ParamFile(str(src / "MOM_input"),
                              str(src / "MOM_override")),
                    device="cpu", dtype=torch.float64)
    n = golden["nsteps"]
    zero_counts(wrappers)
    run = solo.main([str(d), "--days", repr(n * m.dt / 86400.0)])
    per_step = per_step or {"K1": 4, "K2": 1, "K3": 2, "K3m": 0}
    launches = check_driver_launches(
        case, wrappers, {k: v * n for k, v in per_step.items()})
    if run["steps"] != n:
        raise AssertionError(f"{case}: {run['steps']} steps, golden {n}")
    s = run["state"]
    s = s.replace(**{f.name: getattr(s, f.name).cpu()
                     for f in dataclasses.fields(s)
                     if getattr(s, f.name) is not None})
    check_finite([(k, getattr(s, k)) for k in ("h", "u", "v", "T", "S")
                  if getattr(s, k) is not None], s.h.shape)
    st = collect_stats(stat_sums(m.domain, m.grid, m.vgrid, s, m.dt),
                       m.vgrid, n, 0.0)
    checks = (("energy_per_mass", "energy_per_mass", 1e-9, 0.0),
              ("total_mass", "mass", 1e-11, 0.0),
              ("mean_salin", "salt", 0.0, 1e-9),
              ("mean_temp", "temp", 1e-9, 0.0),
              ("max_cfl", "max_cfl", 1e-6, 1e-12),
              ("mean_sea_level", "sea_level", 1e-6, 1e-12))
    for field, key, rtol, atol in checks:
        got, want = float(getattr(st, field)), float(golden[key])
        log(f"  {case} {field}: {got!r}, golden {want!r}, off by "
            f"{abs(got - want):.3e} (limit {atol + rtol * abs(want):.3e})")
        if not abs(got - want) <= atol + rtol * abs(want):
            raise AssertionError(f"{case} {field}: {got!r} against the "
                                 f"golden {want!r}")
    log(f"  {case}: {n} steps, launches {launches}, driver loop "
        f"{run['loop_seconds'] / n * 1e3:.3f} ms/step (CUDA events)"
        + ("" if s.meke is None else
           f", MEKE energy max {float(s.meke.max()):.4e} m2 s-2"))
    return launches


def check_file_modules():
    """The ninth breadth item's modules on the card against the CPU in
    fp64, 1e-12 relative to each field's maximum: the land fill and
    bilinear regrid of BENCH_CONFIG_FILE's z file, the z-space initial T
    and S and the sponge targets of its build at 32x32x6 (each device
    builds its own), the layer, ALE (33 reference levels onto 6) and
    interface sponges on seeded inputs, and the data override with the
    file wind and fluxes at a model time."""
    import numpy as np
    import torch
    from mom6_torch import configs, entry
    from mom6_torch.initialization import bilinear_regrid, fill_missing
    from mom6_torch.param.vertical.sponge import (apply_eta_sponge,
                                                  apply_sponge)
    ff = configs.file_fields(32, 32, 0)["ts_z.nc"]
    src = ff["ptemp"].astype(np.float64)
    dst = np.meshgrid(np.linspace(-5.0, 330.0, 40), np.linspace(0.0, 320.0,
                                                                 40))

    def regrid(dev):
        f = fill_missing(src, src > -1e10, device=dev)
        return f, bilinear_regrid(f, ff["lon"], ff["lat"], dst[0], dst[1])

    out = {}
    (out["cpu fill"], out["cpu regrid"]), (out["card fill"],
                                           out["card regrid"]) = (
        regrid("cpu"), regrid(DEV))
    ms = {lab: (dev, entry.build_full(*SMALL_FULL, dynamics="file",
                                      device=dev, dtype=torch.float64))
          for lab, dev in (("cpu", "cpu"), ("card", DEV))}
    rng = np.random.default_rng(9)
    mc = ms["cpu"][1]
    nk = mc.state.h.shape[0]
    shape = tuple(mc.state.h.shape)
    idamp = rng.uniform(0.0, 1.0 / 86400.0, shape[1:])
    T_l = rng.uniform(2.0, 20.0, shape)
    d_ref = np.cumsum(np.concatenate([np.zeros((1,) + shape[1:]),
                                      rng.uniform(10.0, 900.0, shape)]), 0)
    for lab, (dev, m) in ms.items():
        def t(a, dev=dev):
            return torch.as_tensor(np.asarray(a), dtype=torch.float64,
                                   device=dev)
        sd, st = m.cfg.sponge, m.state
        out[f"{lab} z-init T"], out[f"{lab} z-init S"] = st.T, st.S
        for k in ("idamp", "T", "S", "ref_h"):
            out[f"{lab} sponge {k}"] = sd[k]
        out[f"{lab} ALE sponge T"] = apply_sponge(
            {"T": st.T}, st.h, sd["idamp"], 1200.0, {"T": sd["T"]},
            ref_h=sd["ref_h"])["T"]
        out[f"{lab} layer sponge T"] = apply_sponge(
            {"T": st.T}, st.h, t(idamp), 1200.0, {"T": t(T_l)})["T"]
        out[f"{lab} eta sponge h"] = apply_eta_sponge(
            st.h, t(idamp), 1200.0, t(d_ref))
        fc, fl = m.forcing(st, 5.3e6, True)
        for k in ("taux", "tauy"):
            out[f"{lab} forcing {k}"] = getattr(fc, k)
        for k in ("sw", "lw", "latent", "sensible", "evap", "lprec"):
            out[f"{lab} forcing {k}"] = getattr(fl, k)
    errs = {}
    for k in [k[4:] for k in out if k.startswith("cpu ")]:
        rel, _ = rel_err(out["cpu " + k], out["card " + k].cpu(), H=0)
        errs[k] = rel
        if not rel <= 1e-12:
            raise AssertionError(f"{k}: card vs cpu {rel:.3e} > 1e-12")
    if nk == mc.cfg.sponge["ref_h"].shape[0]:
        raise AssertionError("the ALE sponge's reference grid has NK levels")
    log("  file-driven modules card vs cpu max rel err "
        + ", ".join(f"{k} {v:.1e}" for k, v in errs.items()))
    return max(errs.values())


def file_extra(m, cur, fstep, n_done):
    """For BENCH_CONFIG_FILE: one thermodynamic step under the profiler
    with profile_step's ranges: the device time, host time and kernels
    of the sponge, the file forcing's interpolation in time, the data
    override, the ALE call and the diabatic driver, and the step's idle
    share."""
    from mom6_torch import profile_step
    while (n_done[0] + 1) % m.cfg.n_dyn_per_therm != 0:
        fstep()
    summary = profile_step._profile(fstep, profile_step.slice2_targets(
        "file"), "file thermo", None)
    ph = summary.get("phases", {})
    got = {k: ph[k] for k in FILE_PHASES if k in ph}
    log(f"  profiled thermodynamic step: device busy "
        f"{summary.get('device_busy_ms', 0.0):.3f} ms, idle share "
        f"{summary.get('idle_share_profiled', float('nan')):.1%}, "
        f"{summary.get('kernels', 0)} kernels; "
        + "; ".join(f"{k} x{v['calls']}: {v['kernels']} kernels "
                    f"{v['device_ms']:.4f} ms device, {v['host_ms']:.3f} "
                    "ms host" for k, v in got.items()))
    for k in FILE_NEEDED:
        if k not in got:
            raise AssertionError(f"file: no {k} in a thermodynamic step")
    return dict(profiled_thermo=dict(
        device_busy_ms=summary.get("device_busy_ms"),
        idle_share=summary.get("idle_share_profiled"),
        kernels=summary.get("kernels"), phases=got))


def parse_stats(text):
    """[(step, {field: value})] of ocean.stats lines without their
    header; day and truncs among the fields."""
    rows = []
    for line in text.splitlines():
        step, day, truncs, *rest = [c.strip() for c in line.split(",")]
        row = {"day": float(day), "truncs": int(truncs)}
        row.update((k, float(v)) for k, v in (c.split(None, 1)
                                               for c in rest))
        rows.append((int(step), row))
    return rows


def gen_ref_tc4(d):
    """cases/ref_tc4's input files (not in the repository) written into
    ``d`` by the case's own gen_data.py, with the port's NetCDF writer
    in place of the JAX package's."""
    src = (ROOT / "cases" / "ref_tc4" / "gen_data.py").read_text()
    old = "from mom6_tpu.framework.io import write_fields"
    if old not in src:
        raise AssertionError("cases/ref_tc4/gen_data.py: no writer import")
    ns = {"__name__": "ref_tc4_gen_data",
          "__file__": str(Path(d) / "gen_data.py")}
    exec(compile(src.replace(old, "from mom6_torch.framework.io import "
                             "write_fields"), "gen_data.py", "exec"), ns)
    ns["gen"](str(d))


def run_file_cases(tmp, wrappers):
    """cases/tc4, ref_tc4 and tc2 through the solo driver in fp64 on the
    card, each with every launch counter zeroed just before and read
    just after (K1 4, K2 1, K3 2 a step): tc4 against the JAX driver's
    ocean.stats (TC4_JAX_STATS: the same steps, days and truncations,
    En, CFL, M, S and T to 1e-9 relative, SL and Me to 1e-12 absolute);
    ref_tc4, run in its case directory (its INPUTDIR is "."), against
    its golden as run_ref_case holds ref_tc1; tc2 finite, with the step
    and day columns of the JAX driver's ocean.stats (TC2_JAX_STEPS).
    Returns the launches of each."""
    import os
    import shutil
    from mom6_torch.drivers import solo
    out = {}
    per = {"K1": 4, "K2": 1, "K3": 2, "K3m": 0}
    # tc4 reads INPUTDIR = "cases/tc4" from the root of the checkout
    d = Path(tmp) / "tc4_card"
    d.mkdir()
    shutil.copy(ROOT / "cases" / "tc4" / "MOM_input", d / "MOM_input")
    cwd = os.getcwd()
    os.chdir(ROOT)
    try:
        zero_counts(wrappers)
        run = solo.main([str(d)])
    finally:
        os.chdir(cwd)
    n = run["steps"]
    out["tc4"] = check_driver_launches(
        "driver tc4", wrappers, {k: v * n for k, v in per.items()})
    got, want = read_stats(d / "ocean.stats"), parse_stats(TC4_JAX_STATS)
    if [s for s, _ in got] != [s for s, _ in want]:
        raise AssertionError(f"driver tc4: stats steps {got} against "
                             f"{want}")
    worst = {}
    for (step, w), (_, g) in zip(want, got):
        for k, a in w.items():
            absolute = k in ("SL", "Me")
            err = abs(g[k] - a) if absolute or a == 0.0 else \
                abs(g[k] - a) / abs(a)
            worst[k] = max(worst.get(k, 0.0), err)
            if k in ("day", "truncs") and g[k] != a or \
                    not err <= (1e-12 if absolute else 1e-9):
                raise AssertionError(f"driver tc4 step {step} {k}: "
                                     f"{g[k]!r} against the JAX {a!r}")
    log(f"  tc4: {n} steps, card against the JAX driver's ocean.stats: "
        + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
        + f" (SL [m] and Me absolute); launches {out['tc4']}")
    # ref_tc4 reads its files from its case directory
    d = Path(tmp) / "ref_tc4_card"
    shutil.copytree(ROOT / "cases" / "ref_tc4", d)
    gen_ref_tc4(d)
    os.chdir(d)
    try:
        out["ref_tc4"] = run_ref_case(tmp, wrappers, "ref_tc4", d)
    finally:
        os.chdir(cwd)
    # tc2: PPM_H4 over the spoon's vanished layers
    d = Path(tmp) / "tc2_card"
    d.mkdir()
    shutil.copy(ROOT / "cases" / "tc2" / "MOM_input", d / "MOM_input")
    zero_counts(wrappers)
    run = solo.main([str(d)])
    n = run["steps"]
    out["tc2"] = check_driver_launches(
        "driver tc2", wrappers, {k: v * n for k, v in per.items()})
    got = read_stats(d / "ocean.stats")
    if [(s, r["day"]) for s, r in got] != TC2_JAX_STEPS:
        raise AssertionError(f"driver tc2: steps and days "
                             f"{[(s, r['day']) for s, r in got]}")
    for step, row in got:
        bad = [k for k, v in row.items() if v != v or abs(v) == float("inf")]
        if bad:
            raise AssertionError(f"driver tc2 step {step}: {row}")
    s = run["state"]
    check_finite([(k, getattr(s, k)) for k in ("h", "u", "v", "T", "S")],
                 s.h.shape)
    log(f"  tc2: {n} steps finite, steps and days those of the JAX "
        f"driver; last line En {got[-1][1]['En']!r}, CFL "
        f"{got[-1][1]['CFL']!r}, truncations {got[-1][1]['truncs']}; "
        f"launches {out['tc2']}")
    return out


def check_bgc_modules():
    """The seventh breadth item's modules on the card against the CPU in
    fp64, 1e-12 relative to each field's largest value, on seeded inputs
    at the 32x32x6 build of BENCH_CONFIG_BGC with the ideal packages of
    IDEAL_LINES beside its coupler (each device builds its own): every
    tracer's initial field and its column function, GasSpec.flux of the
    O2, CO2 and CFC specs, the coupler's column_physics with every
    channel on and a gas_fields override (once with the shortwave's
    light, once through the implicit vertical diffusion), NPZD's own
    column_physics, RestoringData.tendencies (33 file levels onto 6) and
    step_offline.  Returns the largest error."""
    import numpy as np
    import torch
    from mom6_torch import entry
    from mom6_torch.core.forcing import Fluxes
    from mom6_torch.tracer.bgc_interface import NPZDPackage
    from mom6_torch.tracer.offline import OfflineCfg, step_offline
    ms = {lab: (dev, entry.build_full(*SMALL_FULL, dynamics="bgc",
                                      extra=IDEAL_LINES, device=dev,
                                      dtype=torch.float64))
          for lab, dev in (("cpu", "cpu"), ("card", DEV))}
    mc = ms["cpu"][1]
    shape = tuple(mc.state.h.shape)
    rng = np.random.default_rng(19)
    h = rng.uniform(20.0, 300.0, shape)
    T = rng.uniform(0.0, 28.0, shape)
    S = rng.uniform(32.0, 37.0, shape)
    sw = rng.uniform(0.0, 300.0, shape[1:])
    kd = rng.uniform(1e-5, 1e-2, (shape[0] + 1,) + shape[1:])
    salt = rng.uniform(-1e-6, 1e-6, shape[1:])
    open_frac = rng.uniform(0.0, 1.0, shape[1:])
    gas = {"atm_co2": rng.uniform(3e-4, 5e-4, shape[1:]),
           "u10": rng.uniform(2.0, 12.0, shape[1:])}
    trs = {k: rng.uniform(0.5, 1.5, shape) * max(float(v.max()), 1.0)
           for k, v in mc.tracers.items()}
    npzd = {k: rng.uniform(0.0, 12.0, shape)
            for k in ("no3", "phyto", "zoo", "det")}
    area = mc.grid.areaT.numpy()
    # transports of at most a fifth of the cell volumes, none at the walls
    uh = 0.2 * rng.uniform(-1.0, 1.0, shape) * h * area \
        * mc.grid.mask2dCu.numpy()
    vh = 0.2 * rng.uniform(-1.0, 1.0, shape) * h * area \
        * mc.grid.mask2dCv.numpy()
    out = {}
    for lab, (dev, m) in ms.items():
        def t(a, dev=dev):
            return torch.as_tensor(np.asarray(a), dtype=torch.float64,
                                   device=dev)
        bgc = m.cfg.bgc
        for k, v in m.tracers.items():
            out[f"{lab} initial {k}"] = v
        st = m.state.replace(h=t(h), T=t(T), S=t(S))
        got = m.registry.apply_column_fns({k: t(v) for k, v in trs.items()},
                                          st.h, 1200.0, state=st, t=1800.0)
        for k in trs:
            out[f"{lab} column function {k}"] = got[k]
        fl = Fluxes(salt_flux=t(salt), sw=t(sw),
                    gas_fields={k: t(v) for k, v in gas.items()})
        for kw in ({"sw": t(sw)}, {"kd_int": t(kd)}):
            got = bgc.column_physics({k: t(v) for k, v in trs.items()},
                                     t(h), t(T), t(S), 1200.0, t=4.1e6,
                                     fluxes=fl, **kw)
            for k in bgc._specs:
                out[f"{lab} column_physics ({next(iter(kw))}) {k}"] = got[k]
        for name, spec in bgc._specs.items():
            if spec.gas is not None:
                out[f"{lab} GasSpec.flux {name}"] = spec.gas.flux(
                    t(trs[name][0]), t(T[0]), t(S[0]), t(gas["u10"]),
                    t(gas["atm_co2"]), t(open_frac))
        got = bgc.restoring.tendencies(
            {k: t(trs[k]) for k in bgc.restoring.clim}, t(h))
        for k, v in got.items():
            out[f"{lab} RestoringData {k}"] = v
        got = NPZDPackage().column_physics(
            {k: t(v) for k, v in npzd.items()}, t(h), None, None, 1800.0)
        for k, v in got.items():
            out[f"{lab} NPZD {k}"] = v
        got, h_off = step_offline(
            m.domain, m.grid, {k: t(v) for k, v in trs.items()}, t(h), t(uh),
            t(vh), t(kd), OfflineCfg(dt_offline=7200.0), registry=m.registry)
        out[f"{lab} step_offline h_end"] = h_off
        for k, v in got.items():
            out[f"{lab} step_offline {k}"] = v
    errs = {}
    for k in [k[4:] for k in out if k.startswith("cpu ")]:
        rel, _ = rel_err(out["cpu " + k], out["card " + k].cpu(), H=0)
        errs[k] = rel
        if not rel <= 1e-12:
            raise AssertionError(f"{k}: card vs cpu {rel:.3e} > 1e-12")
    worst = max(errs, key=errs.get)
    log(f"  BGC modules card vs cpu: {len(errs)} fields, max rel err "
        f"{errs[worst]:.3e} ({worst}); by module: " + ", ".join(
            f"{mod} {max(v for k, v in errs.items() if k.startswith(mod)):.1e}"
            for mod in ("initial", "column function", "column_physics",
                        "GasSpec.flux", "RestoringData", "NPZD",
                        "step_offline")))
    return errs[worst]


def bgc_extra(m, cur, fstep, n_done, wrappers):
    """For BENCH_CONFIG_BGC: every BGC tracer >= 0 on the compute domain;
    one thermodynamic step under the profiler with profile_step's ranges
    (BGC_PHASES: device time, host time, kernels); then phase 7k,
    offline mode at full width: 2 OFFLINE_STEPS more steps record the
    (uhtr, vhtr, h_end) of OFFLINE_STEPS thermodynamic intervals through
    step.offline_fields(), and step_offline advances the text's 13
    passive tracers from them with the registry's column functions, as
    the driver runs it, each step timed by CUDA events, with no kernel
    launched; every tracer without a column function keeps its content
    (over the step's own start volumes, in fp64 sums) to 1e-5
    relative."""
    import torch
    from mom6_torch import profile_step
    from mom6_torch.parallel.stencil import im1, jm1
    from mom6_torch.tracer.offline import OfflineCfg, step_offline
    d, g = m.domain, m.grid
    _, _, tr = cur
    bgc = list(m.cfg.bgc._specs)
    lows = {k: float(d.interior(tr[k]).min()) for k in bgc}
    if min(lows.values()) < 0.0:
        raise AssertionError(f"bgc: a BGC tracer below 0: {lows}")
    log("  BGC tracers on the compute domain, min: " + ", ".join(
        f"{k} {v:.3e}" for k, v in lows.items()))
    while (n_done[0] + 1) % m.cfg.n_dyn_per_therm != 0:
        fstep()
    summary = profile_step._profile(fstep, profile_step.slice2_targets(
        "bgc"), "bgc thermo", None)
    ph = summary.get("phases", {})
    got = {k: ph[k] for k in BGC_PHASES if k in ph}
    log(f"  profiled thermodynamic step: device busy "
        f"{summary.get('device_busy_ms', 0.0):.3f} ms, idle share "
        f"{summary.get('idle_share_profiled', float('nan')):.1%}, "
        f"{summary.get('kernels', 0)} kernels; "
        + "; ".join(f"{k} x{v['calls']}: {v['kernels']} kernels "
                    f"{v['device_ms']:.4f} ms device, {v['host_ms']:.3f} "
                    "ms host" for k, v in got.items()))
    missing = [k for k in BGC_PHASES if k not in got]
    if missing:
        raise AssertionError(f"bgc: no {missing} in a thermodynamic step")

    # 7k. offline mode at full width
    log(f"phase 7k offline mode (step_offline) %dx%dx%d fp32, "
        % MAIN + f"{OFFLINE_STEPS} steps from the recorded intervals")
    records = []
    while len(records) < OFFLINE_STEPS:
        fstep()
        off = fstep.offline_fields()
        if off is not None and (not records or off is not records[-1]):
            records.append(off)
    _, _, tr = cur
    tracers = dict(tr)
    cfg = OfflineCfg(dt_offline=m.dt_therm)
    area = g.areaT.double()
    with_fn = {k for k in tracers if m.registry.meta(k).column_fn}
    ms, worst = [], 0.0
    zero_counts(wrappers)
    for n, (uh, vh, h_end) in enumerate(records):
        he, uf, vf = (x.double() for x in d.fill_halos((h_end, uh, vh),
                                                        width=2))
        vol0 = he * area + (uf - im1(uf)) + (vf - jm1(vf))
        before = {k: float(torch.sum(d.interior(v.double() * vol0)))
                  for k, v in tracers.items() if k not in with_fn}
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        tracers, h_out = step_offline(d, g, tracers, h_end, uh, vh, None,
                                      cfg, registry=m.registry,
                                      x_first=(n % 2 == 0))
        ev[1].record()
        torch.cuda.synchronize()
        ms.append(ev[0].elapsed_time(ev[1]))
        for k, c0 in before.items():
            c1 = float(torch.sum(d.interior(tracers[k].double()
                                            * h_out.double() * area)))
            rel = abs(c1 - c0) / max(abs(c0), 1e-300)
            worst = max(worst, rel)
            if not rel <= 1e-5:
                raise AssertionError(f"offline step {n} {k}: content "
                                     f"{c1!r} against {c0!r}")
    launched = {k: v for k, v in read_counts(wrappers).items() if v}
    if launched:
        raise AssertionError(f"offline mode launched kernels: {launched}")
    check_finite(sorted(tracers.items()), h_out.shape)
    log(f"  {len(records)} offline steps ({len(tracers)} tracers, "
        f"{cfg.tracer_adv.n_sweep_pairs} sweep pairs, dt {m.dt_therm:g} s): "
        f"{sum(ms[1:]) / max(len(ms) - 1, 1):.3f} ms a step after the first "
        f"(CUDA events; each: {', '.join(f'{x:.3f}' for x in ms)}); no "
        f"kernel launched; the {len(before)} tracers without a column "
        f"function keep their content to {worst:.3e} relative")
    return dict(profiled_thermo=dict(
        device_busy_ms=summary.get("device_busy_ms"),
        idle_share=summary.get("idle_share_profiled"),
        kernels=summary.get("kernels"), phases=got),
        bgc_min=lows, offline_ms=ms, offline_conservation=worst)


def isomip_cavity(device):
    """tests/test_isomip_shelf.py's ISOMIP cavity in fp64 on ``device``:
    48x8 cells of 10 km over the ISOMIP bed (540 m at the west wall to
    900 m), the ice 800 m at the wall thinning to 200 m at 55 % of the
    channel; (domain, grid, h, mask)."""
    import numpy as np
    import torch
    from mom6_torch.core.grid import cartesian_grid
    from mom6_torch.parallel.domain import Domain
    from mom6_torch.user.configs import topo_isomip
    d = Domain(ni=48, nj=8, halo=4)
    ctx = {"max_depth": 900.0, "west": 0.0, "lenlon": 480.0}
    g = cartesian_grid(d, 480.0, 80.0, f0=-1.4e-4, beta=0.0, max_depth=900.0,
                       depth_fn=lambda lo, la: topo_isomip(lo, la, ctx),
                       device=device, dtype=torch.float64)
    lon = g.geoLonT.cpu().numpy()
    xn = np.clip((lon - lon.min()) / 480.0, 0.0, 1.0)
    h = np.where(xn < 0.55, 800.0 + (200.0 - 800.0) * xn / 0.55, 0.0) \
        * g.mask2dT.cpu().numpy()
    h = d.fill_halos(torch.as_tensor(h, device=device, dtype=torch.float64))
    return d, g, h, (h > 1e-3).double()


def check_shelf_modules(tmp):
    """The ice shelf's modules card against CPU in fp64, at SSA_TOL:
    three_equation_melt on seeded inputs; the default SSA solve (24
    Picard refreshes of 200 CG iterations, Weertman drag over the
    grounded cells) on the ISOMIP cavity; two steps of step_shelf there
    with grounding on the bed, Coulomb friction, the ISOMIP profile's
    melt, the front advancing and the ice temperature evolving; then the
    shelf-only driver on tests/test_shelf_coupling.py's case on the card
    and with --cpu: the shelf.stats lines (the volume to 1e-12, the
    speed as printed) and shelf_final.nc."""
    import numpy as np
    import torch
    from mom6_torch.drivers import shelf_solo
    from mom6_torch.framework.io import read_field
    from mom6_torch.ice_shelf import dynamics, shelf_main, thermo
    worst = {}

    def hold(name, ref, out, H=4, tol=SSA_TOL):
        err = rel_err(ref, out.cpu(), H)[0]
        worst[name] = err
        if not err <= tol:
            raise AssertionError(f"shelf {name}: card vs cpu {err:.3e} > "
                                 f"{tol:.1e}")

    rng = np.random.default_rng(3)
    t_w, s_w, p_b = (torch.as_tensor(a, dtype=torch.float64) for a in (
        rng.uniform(-2.5, 2.0, (64, 64)), rng.uniform(30.0, 35.0, (64, 64)),
        rng.uniform(0.0, 9e6, (64, 64))))
    mask = torch.as_tensor((rng.random((64, 64)) < 0.6).astype(np.float64))
    cfg = thermo.IceShelfCfg()
    cpu = thermo.three_equation_melt(cfg, t_w, s_w, p_b, mask)
    card = thermo.three_equation_melt(cfg, *(a.to(DEV) for a in (
        t_w, s_w, p_b, mask)))
    for name, a, b in zip(cpu._fields, cpu, card):
        hold(f"melt {name}", a, b, H=0)
    runs = {}
    for dev in ("cpu", DEV):
        d, g, h, m = isomip_cavity(dev)
        scfg = shelf_main.ShelfCfg(ssa=dynamics.SSACfg(c_basal=1e10))
        st = shelf_main.ShelfState(h_shelf=h, bed_elev=g.bathyT)
        gf = shelf_main.update_grounding(scfg, st)[1]
        res = dynamics.ssa_velocity_solve(scfg.ssa, g, h, m, ground_frac=gf,
                                          bed_elev=g.bathyT)
        kw = dict(n_outer=3, n_inner=20, c_basal=1e10, coulomb=True)
        scfg = shelf_main.ShelfCfg(ssa=dynamics.SSACfg(**kw),
                                   evolve_temp=True)
        t_sh = torch.where(m > 0, torch.as_tensor(np.random.default_rng(
            13).uniform(-25.0, -5.0, tuple(h.shape)), dtype=h.dtype,
            device=dev), -10.0)
        st = shelf_main.ShelfState(h_shelf=h, area_frac=m,
                                   bed_elev=g.bathyT, t_shelf=t_sh)
        u = v = None
        for _ in range(2):
            draft, pb = thermo.shelf_draft(scfg.thermo, st.h_shelf)
            frac = torch.clamp(draft / 900.0, 0.0, 1.0)
            melt = thermo.three_equation_melt(
                scfg.thermo, -1.9 + 2.9 * frac, 33.8 + 0.75 * frac, pb,
                shelf_mask=st.mask(scfg.min_thickness)).melt
            st, u, v = shelf_main.step_shelf(d, g, st, scfg, 10.0 * 86400.0,
                                             melt=melt, u0=u, v0=v)
        runs[dev] = (res, st, u, v)
    (r0, s0, u0, v0), (r1, s1, u1, v1) = runs["cpu"], runs[DEV]
    for name, a, b in zip(r0._fields, r0, r1):
        hold(f"ssa {name}", a, b)
    for name in ("h_shelf", "area_frac", "t_shelf"):
        hold(f"step_shelf {name}", getattr(s0, name), getattr(s1, name))
    hold("step_shelf u", u0, u1)
    hold("step_shelf v", v0, v1)
    a = s1.area_frac[4:-4, 4:-4]
    if not bool(((a > 0) & (a < 1)).any()):
        raise AssertionError("step_shelf: no partial front cell")
    dirs = {}
    for name in ("card", "cpu"):
        dirs[name] = Path(case_dir(tmp, f"shelf_solo_{name}",
                                   SHELF_SOLO_SMALL))
        shelf_solo.main([str(dirs[name])] + (["--cpu"] if "cpu" in (
            name, DEV) else []))
    rows = {k: [[float(c) for c in r.split(",")] for r in (
        v / "shelf.stats").read_text().splitlines()[1:]]
        for k, v in dirs.items()}
    for w, g in zip(rows["cpu"], rows["card"]):
        if g[:2] != w[:2] or abs(g[2] - w[2]) > 1e-12 * abs(w[2]) \
                or abs(g[3] - w[3]) > 1.5e-4:
            raise AssertionError(f"shelf_solo: card {g} against cpu {w}")
    for var in ("thick", "u", "v"):
        hold(f"shelf_solo {var}", torch.as_tensor(read_field(
            str(dirs["cpu"] / "shelf_final.nc"), var)), torch.as_tensor(
            read_field(str(dirs["card"] / "shelf_final.nc"), var)), H=0)
    log("  shelf modules card vs cpu max rel err (limit %.1e): " % SSA_TOL
        + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()))
    log(f"  shelf-only driver, {len(rows['card'])} shelf.stats lines equal "
        f"card against cpu: last {rows['card'][-1]}")
    return worst


def shelf_extra(m, cur, fstep, n_done):
    """For BENCH_CONFIG_SHELF: the melt rate's range under the shelf on
    the last state, and one thermodynamic step under the profiler with
    profile_step's ranges: the device time, host time and kernels of the
    shelf's coupling (ice_shelf/fluxes) beside the pressure force, the
    diabatic driver and the ALE call, and the step's idle share."""
    import torch
    from mom6_torch import profile_step
    from mom6_torch.ice_shelf import shelf_main
    st = cur[0]
    sc, ss = m.shelf_cfg, m.ice_shelf
    under = ss.mask(sc.min_thickness)[4:-4, 4:-4] > 0
    melt = shelf_main.shelf_fluxes(sc, ss, st.T[0], st.S[0])[2][4:-4, 4:-4]
    mr = melt[under]
    if not bool(torch.isfinite(mr).all()):
        raise AssertionError("shelf: the melt rate is not finite")
    rate = (mr.double() / sc.thermo.rho_ice * 365.0 * 86400.0)
    log(f"  melt under the shelf ({int(under.sum())} cells): "
        f"[{float(mr.min())!r}, {float(mr.max())!r}] kg m-2 s-1, mean "
        f"{float(rate.mean()):.3f} m of ice a year; top layer T there "
        f"[{float(st.T[0][4:-4, 4:-4][under].min()):.4f}, "
        f"{float(st.T[0][4:-4, 4:-4][under].max()):.4f}] degC")
    while (n_done[0] + 1) % m.cfg.n_dyn_per_therm != 0:
        fstep()
    summary = profile_step._profile(fstep, profile_step.slice2_targets(
        "shelf"), "shelf thermo", None)
    ph = summary.get("phases", {})
    got = {k: ph[k] for k in SHELF_PHASES if k in ph}
    log(f"  profiled thermodynamic step: device busy "
        f"{summary.get('device_busy_ms', 0.0):.3f} ms, idle share "
        f"{summary.get('idle_share_profiled', float('nan')):.1%}, "
        f"{summary.get('kernels', 0)} kernels; "
        + "; ".join(f"{k} x{v['calls']}: {v['kernels']} kernels "
                    f"{v['device_ms']:.4f} ms device, {v['host_ms']:.3f} "
                    "ms host" for k, v in got.items()))
    if "ice_shelf/fluxes" not in got:
        raise AssertionError("shelf: no ice_shelf/fluxes in a "
                             "thermodynamic step")
    return dict(melt_range=[float(mr.min()), float(mr.max())],
                melt_m_per_year=float(rate.mean()),
                profiled_thermo=dict(
                    device_busy_ms=summary.get("device_busy_ms"),
                    idle_share=summary.get("idle_share_profiled"),
                    kernels=summary.get("kernels"), phases=got))


def run_shelf_solo(tmp, wrappers):
    """The shelf-only step at full width (SHELF_SOLO_TEXT, fp64), built
    as drivers/shelf_solo.py builds it: SHELF_SOLO_STEPS steps, each
    between two CUDA events, with every launch counter zeroed just
    before and read just after (the step runs none of the kernels); the
    last CG residual norm of each Picard refresh of each step; the ice
    volume (thickness times the covered fraction) kept to 1e-8 relative,
    as tests/test_shelf_coupling.py keeps it; then one more step under
    the profiler with profile_step's ice_shelf/ssa range: its kernels
    and idle share."""
    import torch
    from mom6_torch import profile_step
    from mom6_torch.drivers import shelf_solo
    from mom6_torch.framework.config import ParamFile
    from mom6_torch.ice_shelf import shelf_main
    case = shelf_solo.build_shelf_case(
        ParamFile(case_dir(tmp, "shelf_solo_full", SHELF_SOLO_TEXT)
                  + "/MOM_input"), device=DEV)
    d, g, cfg, dt = case.domain, case.grid, case.cfg, case.dt

    def volume(s):
        return float(torch.sum(d.interior(s.h_shelf * s.area_frac
                                          * g.areaT)))

    cur = [case.shelf, None, None]
    vol0 = volume(cur[0])
    residuals = []

    def step(res=None):
        r = shelf_main.step_shelf(d, g, cur[0], cfg, dt, u0=cur[1],
                                  v0=cur[2], residuals=res)
        cur[:] = [r.state, r.u, r.v]

    torch.cuda.synchronize()
    zero_counts(wrappers)
    events = [torch.cuda.Event(enable_timing=True)
              for _ in range(SHELF_SOLO_STEPS + 1)]
    events[0].record()
    for i in range(SHELF_SOLO_STEPS):
        res = []
        step(res)
        events[i + 1].record()
        residuals.append(res)
    torch.cuda.synchronize()
    counts = read_counts(wrappers)
    if any(counts.values()):
        raise AssertionError(f"shelf-only step launched kernels {counts}")
    per = [events[i].elapsed_time(events[i + 1])
           for i in range(SHELF_SOLO_STEPS)]
    vol1 = volume(cur[0])
    check_finite([("h_shelf", cur[0].h_shelf), ("u", cur[1]),
                  ("v", cur[2])], (1,) + tuple(cur[0].h_shelf.shape))
    if not abs(vol1 - vol0) <= 1e-8 * abs(vol0):
        raise AssertionError(f"shelf-only: ice volume {vol1!r} against "
                             f"{vol0!r}")
    res_norms = [[float(r) for r in rs] for rs in residuals]
    spd = float(torch.sqrt(cur[1] ** 2 + cur[2] ** 2).max()) * 3.15e7
    log(f"  {SHELF_SOLO_STEPS} steps of {dt:g} s: "
        + ", ".join(f"{t:.3f}" for t in per) + f" ms (CUDA events), mean "
        f"{sum(per) / len(per):.3f} ms a step; ice volume {vol1!r} m3 "
        f"against {vol0!r} (rel {abs(vol1 - vol0) / vol0:.3e}); max speed "
        f"{spd:.4f} m/a; launches {counts}")
    for i, rs in enumerate(res_norms):
        log(f"  step {i + 1}: last CG residual norm of each of the "
            f"{len(rs)} Picard refreshes: "
            + ", ".join(f"{r:.3e}" for r in rs))
    t0 = time.perf_counter()
    summary = profile_step._profile(step, profile_step.SHELF_SOLO,
                                    "shelf-only", None)
    ssa = summary.get("phases", {}).get("ice_shelf/ssa", {})
    log(f"  profiled step ({time.perf_counter() - t0:.1f} s with the "
        f"profiler and its trace): {summary.get('kernels', 0)} kernels, "
        f"device busy {summary.get('device_busy_ms', 0.0):.3f} ms of "
        f"{summary.get('profiled_step_ms', 0.0):.3f} ms, idle share "
        f"{summary.get('idle_share_profiled', float('nan')):.1%}; "
        f"ice_shelf/ssa {ssa.get('kernels', 0)} kernels, "
        f"{ssa.get('device_ms', 0.0):.3f} ms device")
    if not summary.get("kernels"):
        raise AssertionError("shelf-only: the profiler traced no kernel")
    return dict(ms_steps=per, ms_step=sum(per) / len(per), volume=vol1,
                volume0=vol0, residuals=res_norms, launches=counts,
                kernels=summary["kernels"],
                idle_share=summary["idle_share_profiled"],
                device_busy_ms=summary["device_busy_ms"],
                ssa_kernels=ssa.get("kernels"))


def run_phillips(tmp, wrappers):
    """cases/phillips (a reentrant two-layer channel, the thermal-wind
    jet over a sloped interface) through the solo driver for its 2 days
    in fp64 on the card, every launch counter zeroed just before and read
    just after, against the JAX driver's ocean.stats (PHILLIPS_JAX_STATS:
    the same steps, days and truncations, En, CFL, M, S and T to 1e-9
    relative, SL and Me to 1e-12 absolute).  Returns the launches."""
    from mom6_torch.drivers import solo
    d = case_dir(tmp, "phillips_card",
                 (ROOT / "cases" / "phillips" / "MOM_input").read_text())
    zero_counts(wrappers)
    run = solo.main([d])
    n = run["steps"]
    launches = check_driver_launches(
        "driver phillips", wrappers,
        {k: v * n for k, v in {"K1": 4, "K2": 1, "K3": 2, "K3m": 0}.items()})
    got = read_stats(Path(d) / "ocean.stats")
    want = parse_stats(PHILLIPS_JAX_STATS)
    if [s for s, _ in got] != [s for s, _ in want]:
        raise AssertionError(f"driver phillips: stats steps {got} against "
                             f"{want}")
    worst = {}
    for (step, w), (_, g) in zip(want, got):
        for k, a in w.items():
            absolute = k in ("SL", "Me")
            err = abs(g[k] - a) if absolute or a == 0.0 else \
                abs(g[k] - a) / abs(a)
            worst[k] = max(worst.get(k, 0.0), err)
            if k in ("day", "truncs") and g[k] != a or \
                    not err <= (1e-12 if absolute else 1e-9):
                raise AssertionError(f"driver phillips step {step} {k}: "
                                     f"{g[k]!r} against the JAX {a!r}")
    log(f"  phillips: {n} steps, card against the JAX driver's "
        "ocean.stats: " + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
        + f" (SL [m] and Me absolute); last En {got[-1][1]['En']!r}; "
        f"driver loop {run['loop_seconds'] / n * 1e3:.3f} ms/step; "
        f"launches {launches}")
    return launches


def run_offline_cases(tmp, wrappers):
    """The offline round trip of tests/test_offline_driver.py through the
    solo driver in fp64 on the card: online with WRITE_OFFLINE_FIELDS
    (K1 4, K2 1, K3 2 a step), then OFFLINE_TRACER_MODE from its files
    (no launch), each with every launch counter zeroed just before and
    read just after.  With the case's uniform dye the offline dye
    equals the online one to 1e-10; with the dye in a box (DYE_BOX) the
    card's offline dye equals a --cpu offline run's from the same files
    to 1e-12 (it parts from the online dye, in both packages: the
    offline steps alternate x_first, the online thermodynamic steps all
    sweep y first).  Each offline run keeps the dye's content to 1e-12.
    Returns the online runs' launches."""
    import torch
    from mom6_torch.drivers import solo
    from mom6_torch.framework.config import ParamFile
    from mom6_torch.model import build_model
    out = {}
    for label, box in (("uniform", ""), ("box", DYE_BOX)):
        on = case_dir(tmp, f"offline_{label}_online",
                      OFFLINE_CASE + box + "WRITE_OFFLINE_FIELDS = True\n")
        zero_counts(wrappers)
        online = solo.main([on])
        n = online["steps"]
        out[label] = check_driver_launches(
            f"offline {label} online", wrappers,
            {"K1": 4 * n, "K2": n, "K3": 2 * n, "K3m": 0})
        off_text = OFFLINE_CASE + box + (
            f"OFFLINE_TRACER_MODE = True\nOFFLINEDIR = {on}\n"
            "DT_OFFLINE = 2400.0\n")
        runs = {}
        for dev_label, args in (("card", []), ("cpu", ["--cpu"])):
            d = case_dir(tmp, f"offline_{label}_{dev_label}", off_text)
            zero_counts(wrappers)
            runs[dev_label] = solo.main([d] + args)
            check_driver_launches(f"offline {label} {dev_label}", wrappers,
                                  {"K1": 0, "K2": 0, "K3": 0, "K3m": 0})
        m = build_model(ParamFile(text=OFFLINE_CASE + box), device="cpu",
                        dtype=torch.float64)
        dm, area = m.domain, m.domain.interior(m.grid.areaT)
        dye_on = dm.interior(online["tracers"]["dye1"]).cpu()
        dye_off = dm.interior(runs["card"]["tracers"]["dye1"]).cpu()
        dye_cpu = dm.interior(runs["cpu"]["tracers"]["dye1"])
        tot0 = float(torch.sum(dm.interior(m.tracers["dye1"] * m.state.h)
                               * area))
        tot1 = float(torch.sum(dye_off * dm.interior(online["state"].h)
                               .cpu() * area))
        cons = abs(tot1 - tot0) / abs(tot0)
        on_err = float((dye_off - dye_on).abs().max())
        cpu_err = rel_err(dye_cpu, dye_off, H=0)[0]
        log(f"  offline round trip, {label} dye: {n} online steps, "
            f"{runs['card']['steps']} offline steps; offline against online "
            f"{on_err:.3e} (abs), card against cpu offline {cpu_err:.3e} "
            f"(rel), content {tot1!r} against {tot0!r} ({cons:.3e} rel); "
            f"online launches {out[label]}")
        if label == "uniform" and not on_err <= 1e-10:
            raise AssertionError(f"offline dye {on_err:.3e} off the online")
        if not cpu_err <= 1e-12:
            raise AssertionError(f"offline {label}: card vs cpu {cpu_err}")
        if not cons <= 1e-12:
            raise AssertionError(f"offline {label}: content {cons:.3e}")
        if label == "box" and torch.equal(dye_on, dm.interior(
                m.tracers["dye1"])):
            raise AssertionError("offline box: the online dye did not move")
    return out


def cap_text(ni, nj, nk):
    """bench.py's CONFIG with BT_WIDE_HALO_PERIOD = 2 at ni x nj x nk
    with 10 km cells: the text the cap and the ODA phases build."""
    from mom6_torch.configs import BENCH_CONFIG
    return BENCH_CONFIG + (
        f"BT_WIDE_HALO_PERIOD = 2\n#override NIGLOBAL = {ni}\n"
        f"#override NJGLOBAL = {nj}\n#override NK = {nk}\n"
        f"#override LENLON = {ni * 10.0}\n#override LENLAT = {nj * 10.0}\n")


def cap_fields(shape, seed):
    """The cap's import fields on (njh, nih) from a seed, with numpy:
    stresses of the gyre wind's size, a sensible heat loss, four
    shortwave bands, rain and the sea-level pressure."""
    import numpy as np
    rng = np.random.default_rng(seed)
    y = np.linspace(0.0, 1.0, shape[0])[:, None] * np.ones(shape)
    out = {"Foxx_taux": 0.1 * -np.cos(2.0 * np.pi * y)
           + 0.01 * rng.standard_normal(shape),
           "Foxx_tauy": 0.01 * rng.standard_normal(shape),
           "Foxx_sen": -20.0 + 5.0 * rng.standard_normal(shape),
           "Faxa_rain": 1e-5 * rng.random(shape),
           "Sa_pslv": 101325.0 + 100.0 * rng.standard_normal(shape)}
    for band in ("vdr", "vdf", "idr", "idf"):
        out[f"Foxx_swnet_{band}"] = 25.0 + 25.0 * rng.random(shape)
    return out


def cap_interval(device, seeded=False, nudge=False, pslv_noise=True):
    """One interval of the cap (CAP_STEPS steps) over cap_text at
    SMALL_FULL in fp64 under cap_fields(..., 11), from rest or from
    run_full's seeded state.  ``nudge`` moves the initial h by one ulp in
    each cell, up or down by a seeded sign; without ``pslv_noise`` Sa_pslv
    is a uniform 101325 Pa.  Returns u, v, the sea level and the
    exported slopes, on the CPU."""
    import numpy as np
    import torch
    from mom6_torch import entry
    from mom6_torch.drivers import nuopc_cap, ocean_model
    f64 = torch.float64
    cap = nuopc_cap.MOM6Cap().realize(text=cap_text(*SMALL_FULL),
                                      device=device, dtype=f64)
    if seeded:
        m = entry.build_full(*SMALL_FULL, seed=3, device=device, dtype=f64)
        cap._state, cap._split = m.state, m.split
    if nudge:
        h = cap._state.h
        sign = torch.as_tensor(np.random.default_rng(5).choice(
            [-1.0, 1.0], tuple(h.shape)), dtype=f64, device=device)
        cap._state = cap._state.replace(
            h=h + sign * (torch.nextafter(h, 2.0 * h) - h))
    fields = cap_fields(tuple(cap._state.h.shape[1:]), 11)
    if not pslv_noise:
        fields["Sa_pslv"] = np.full_like(fields["Sa_pslv"], 101325.0)
    cap.import_fields(_to(fields, device, f64))
    cap.advance(CAP_STEPS * cap.model.dt)
    out = cap.export_fields()
    lev = ocean_model.extract_surface_state(cap.model, cap._state).sea_lev
    return {"u": cap._state.u.cpu(), "v": cap._state.v.cpu(),
            "sea level": lev.cpu(), "So_dhdx": out["So_dhdx"].cpu(),
            "So_dhdy": out["So_dhdy"].cpu()}


def abs_err_at(ref, out, H=4):
    """(max |ref|, max |ref - out|, its padded index) on the compute
    domain of halo ``H``."""
    import torch
    a, b = ref[..., H:-H, H:-H].double(), out[..., H:-H, H:-H].double()
    d = (a - b).abs()
    at = [int(i) for i in torch.unravel_index(torch.argmax(d), d.shape)]
    at[-2:] = [at[-2] + H, at[-1] + H]
    return float(a.abs().max()), float(d.max()), tuple(at)


def _to(fields, device, dtype):
    import torch
    return {k: torch.as_tensor(v, dtype=dtype, device=device)
            for k, v in fields.items()}


def _worst(label, pairs, limit):
    """The largest relative error on the compute domain of each (name,
    cpu, card) pair, logged; raises above ``limit``."""
    worst = {name: rel_err(a, b.cpu())[0] for name, a, b in pairs}
    log(f"  {label} card vs cpu max rel err (limit {limit:g}): " + ", ".join(
        f"{k} {v:.3e}" for k, v in worst.items()))
    bad = {k: v for k, v in worst.items() if not v <= limit}
    if bad:
        raise AssertionError(f"{label} card vs cpu above {limit:g}: {bad}")
    return worst


def check_tenth(wrappers):
    """Phase 6t: the forcing library, HURR over 3 steps, one ODA cycle,
    one coupling interval of the cap and the particles, card against
    CPU in fp64 at SMALL_FULL."""
    import torch
    from mom6_torch import entry
    from mom6_torch.drivers import nuopc_cap, ocean_model
    from mom6_torch.drivers import surface_forcing as sf
    from mom6_torch.oda import driver as oda, ensemble
    from mom6_torch.tracer import particles
    f64 = torch.float64
    ms = {dev: entry.build_full(*SMALL_FULL, seed=3, dynamics="hurr",
                                device=dev, dtype=f64)
          for dev in (DEV, "cpu")}
    g = {dev: m.grid for dev, m in ms.items()}
    pairs = []
    for t in (300.0, 3900.0):
        fc = {dev: m.forces_fn(t) for dev, m in ms.items()}
        pairs += [(f"hurr {k} t={t:g}", getattr(fc["cpu"], k),
                   getattr(fc[DEV], k)) for k in ("taux", "tauy")]
    x0 = SMALL_FULL[0] * 5e3
    for name, kw in (("scm", dict(scm_mode=True, x0=-3e4, y0=1e4,
                                  dy_from_center=2.5e4)),
                     ("br_bench", dict(br_bench=True, rad_max_wind=2e4,
                                       x0=x0, y0=x0))):
        fc = {dev: sf.idealized_hurricane_fn(sf.HurricaneCfg(**kw), g[dev])(
            1800.0) for dev in g}
        pairs += [(f"{name} {k}", getattr(fc["cpu"], k), getattr(fc[DEV], k))
                  for k in ("taux", "tauy")]
    st = {dev: m.state for dev, m in ms.items()}
    fl = {dev: sf.scm_buoyancy_fn(g[dev], heat_flux=-2e-5, evaporation=1e-7,
                                  max_sw=4e-5)(st[dev], 43500.0) for dev in g}
    pairs += [(f"scm {k}", getattr(fl["cpu"], k), getattr(fl[DEV], k))
              for k in ("sensible", "evap", "sw")]
    fl = {dev: sf.bfb_buoyancy_fn(g[dev], lfr_slat=50.0, lfr_nlat=250.0,
                                  flux_const=0.5)(st[dev], 0.0) for dev in g}
    pairs.append(("bfb sensible", fl["cpu"].sensible, fl[DEV].sensible))
    db = {dev: sf.dumbbell_forcing(sf.DumbbellForcingCfg(flux_const=1.0),
                                   g[dev], 0.0, 320.0, 0.0, 320.0)
          for dev in g}
    pairs += [("dumbbell p_surf", db["cpu"][0](3600.0).p_surf,
               db[DEV][0](3600.0).p_surf),
              ("dumbbell lprec", db["cpu"][1](st["cpu"], 0.0).lprec,
               db[DEV][1](st[DEV], 0.0).lprec)]
    _worst("forcing library", pairs, 1e-12)

    n = 3
    log(f"phase 6t HURR (configs.BENCH_CONFIG_HURR) %dx%dx%d fp64, "
        % SMALL_FULL + f"{n} steps: card vs cpu")
    zero_counts(wrappers)
    gst, gsp, gtr = run_full(*SMALL_FULL, f64, DEV, n, seed=3,
                             regridding=True, dynamics="hurr")
    counts = read_counts(wrappers)
    cst, csp, ctr = run_full(*SMALL_FULL, f64, "cpu", n, seed=3,
                             regridding=True, dynamics="hurr")
    expect = {k: v * n for k, v in PER_STEP["hurr"].items()}
    if counts != expect:
        raise AssertionError(f"HURR: launches {counts}, expected {expect}")
    _worst("HURR", [(k, getattr(cst, k), getattr(gst, k))
                    for k in ("h", "u", "v", "T", "S")]
           + [(k, getattr(csp, k), getattr(gsp, k))
              for k in ("eta", "uh", "vh")]
           + [(k, ctr[k], gtr[k]) for k in ctr], 2.5e-12)
    log(f"  HURR on the card: launches {counts}, max |u| "
        f"{float(gst.u.abs().max()):.4f} m/s")

    log("phase 6t one ODA cycle (2 members, 2 steps) and one coupling "
        "interval of the cap (2 steps): card vs cpu")
    text = cap_text(*SMALL_FULL)
    H = 4
    ji = (H + SMALL_FULL[1] // 2, H + SMALL_FULL[0] // 2)
    runs, caps = {}, {}
    for dev in (DEV, "cpu"):
        # both from the seeded perturbation of run_full's state, as
        # phase 6's paths; the cap from rest is checked below
        seeded = entry.build_full(*SMALL_FULL, seed=3, device=dev,
                                  dtype=f64)
        zero_counts(wrappers)
        m = ocean_model.ocean_model_init(text=text, device=dev, dtype=f64)
        m.state, m.split = seeded.state, seeded.split
        obs = [float(m.state.T[0, ji[0], ji[1]]) + 0.5]
        runs[dev] = oda.run_oda_cycles(m, ensemble.EnsembleCfg(2), 1, 2,
                                       obs, ji, t_pert=0.5, seed=7)
        if dev == DEV:
            oda_counts = read_counts(wrappers)
        cap = nuopc_cap.MOM6Cap().realize(text=text, device=dev, dtype=f64)
        cap._state, cap._split = seeded.state, seeded.split
        cap.import_fields(_to(cap_fields(tuple(m.state.h.shape[1:]), 11),
                              dev, f64))
        zero_counts(wrappers)
        cap.advance(CAP_STEPS * m.dt)
        if dev == DEV:
            cap_counts = read_counts(wrappers)
        caps[dev] = (cap.export_fields(), cap._state,
                     ocean_model.extract_surface_state(cap.model,
                                                       cap._state).sea_lev,
                     cap.model.grid)
    for label, c, per in (("ODA", oda_counts, 2 * 2), ("cap", cap_counts,
                                                       CAP_STEPS)):
        expect = {k: v * per for k, v in PER_STEP["hurr"].items()}
        if c != expect:
            raise AssertionError(f"{label}: launches {c}, expected {expect}")
    a, b = runs["cpu"], runs[DEV]
    _worst("ODA", [(f"{k}[{mm}]", getattr(a.states, k)[mm],
                    getattr(b.states, k)[mm])
                   for k in ("h", "u", "v", "T", "S") for mm in range(2)]
           + [(f"eta[{mm}]", a.splits.eta[mm], b.splits.eta[mm])
              for mm in range(2)], 2.5e-12)
    log(f"  ODA SST mean {b.sst_mean} (cpu {a.sst_mean}), spread "
        f"{b.sst_spread} (cpu {a.sst_spread}); launches {oda_counts}")
    (ea, sa, la, ga), (eb, sb, lb, _) = caps["cpu"], caps[DEV]
    slopes = ("So_dhdx", "So_dhdy")
    _worst("cap", [(k, ea[k], eb[k]) for k in ea if k not in slopes]
           + [("sea level", la, lb)]
           + [(k, getattr(sa, k), getattr(sb, k))
              for k in ("h", "u", "v", "T", "S")], 2.5e-12)
    # the sea level is sum(h) - D: its card vs cpu difference is a few
    # ulps of the 4000 m depth (the order of the layer sum), and its
    # slopes take the difference of two of them over a cell: each slope
    # is held to twice the sea level's largest difference over the
    # smallest spacing
    d_lev = float((la - lb.cpu())[4:-4, 4:-4].abs().max())
    for k, idx in zip(slopes, (ga.IdxCu, ga.IdyCv)):
        err = float((ea[k] - eb[k].cpu())[4:-4, 4:-4].abs().max())
        lim = 2.0 * d_lev * float(idx.max()) * 1.01
        log(f"  cap {k}: max abs err {err:.3e} (limit {lim:.3e}: twice "
            f"the sea level's {d_lev:.3e} m over the spacing), rel "
            f"{rel_err(ea[k], eb[k].cpu())[0]:.3e}")
        if not err <= lim:
            raise AssertionError(f"cap {k}: card vs cpu {err:.3e} > "
                                 f"{lim:.3e}")
    log(f"  cap launches {cap_counts}")
    # from rest, one interval leaves small fields (max |u| ~0.02 m/s)
    # with the same absolute card vs cpu difference as the seeded start:
    # the one a change of the initial h by one ulp leaves on the CPU
    # (tools/cap_roundoff.py).  Each field is held to CAP_ROUNDOFF_TIMES
    # that difference, measured here
    base, nudged = (cap_interval("cpu", nudge=b) for b in (False, True))
    card = cap_interval(DEV)
    for k in base:
        scale, err, at = abs_err_at(base[k], card[k])
        floor = abs_err_at(base[k], nudged[k])[1]
        log(f"  cap from rest {k}: max |x| {scale:.4e}, card vs cpu abs err "
            f"{err:.3e} at {at} (rel {err / scale:.3e}), one ulp of h on "
            f"the cpu {floor:.3e} (limit {CAP_ROUNDOFF_TIMES} times)")
        if not err <= CAP_ROUNDOFF_TIMES * floor:
            raise AssertionError(f"cap from rest {k}: card vs cpu {err:.3e}"
                                 f" > {CAP_ROUNDOFF_TIMES} x {floor:.3e}")

    # particles: 4 RK2 steps in the CPU run's HURR flow on both devices
    xs = torch.linspace(0.25, SMALL_FULL[0] - 0.05, 40, dtype=f64)
    ys = torch.linspace(0.5, SMALL_FULL[1] - 0.5, 40, dtype=f64)
    ks = torch.arange(40) % SMALL_FULL[2]
    pos = {}
    for dev in (DEV, "cpu"):
        m = ms[dev]
        p = particles.init_particles(xs, ys, ks, device=dev)
        u, v = cst.u.to(dev), cst.v.to(dev)
        for _ in range(4):
            p = particles.advect_particles(m.domain, m.grid, p, u, v,
                                           3600.0)
        pos[dev] = p
    worst = {k: rel_err(getattr(pos["cpu"], k)[None],
                        getattr(pos[DEV], k)[None].cpu(), H=0)[0]
             for k in ("x", "y")}
    moved = float((pos["cpu"].x - xs).abs().max())
    log("  particles after 4 steps card vs cpu max rel err (limit 1e-12): "
        + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
        + f"; largest move in x {moved:.4f} cells")
    if not max(worst.values()) <= 1e-12:
        raise AssertionError(f"particles card vs cpu above 1e-12: {worst}")


def hurr_extra(m, cur, fstep, n_done):
    """For BENCH_CONFIG_HURR: the storm's stress at the current time and
    one thermodynamic step under the profiler with profile_step's
    ranges: the device time, host time and kernels of the hurricane's
    stress (forcing/hurricane) beside the pressure force, the diabatic
    driver and the ALE call, and the step's idle share."""
    from mom6_torch import profile_step
    t = (n_done[0] + 0.5) * m.dt
    fc = m.forces_fn(t)
    tau = max(float(fc.taux.abs().max()), float(fc.tauy.abs().max()))
    log(f"  storm at t = {t:g} s: peak stress {tau:.4f} Pa")
    if not tau > 1.0:
        raise AssertionError(f"hurr: peak stress {tau} Pa")
    while (n_done[0] + 1) % m.cfg.n_dyn_per_therm != 0:
        fstep()
    summary = profile_step._profile(fstep, profile_step.slice2_targets(
        "hurr"), "hurr thermo", None)
    ph = summary.get("phases", {})
    got = {k: ph[k] for k in HURR_PHASES if k in ph}
    log(f"  profiled thermodynamic step: device busy "
        f"{summary.get('device_busy_ms', 0.0):.3f} ms, idle share "
        f"{summary.get('idle_share_profiled', float('nan')):.1%}, "
        f"{summary.get('kernels', 0)} kernels; "
        + "; ".join(f"{k} x{v['calls']}: {v['kernels']} kernels "
                    f"{v['device_ms']:.4f} ms device, {v['host_ms']:.3f} "
                    "ms host" for k, v in got.items()))
    if "forcing/hurricane" not in got:
        raise AssertionError("hurr: no forcing/hurricane in a "
                             "thermodynamic step")
    return dict(peak_stress_pa=tau, profiled_thermo=dict(
        device_busy_ms=summary.get("device_busy_ms"),
        idle_share=summary.get("idle_share_profiled"),
        kernels=summary.get("kernels"), phases=got))


def run_cap_timed(wrappers, shape):
    """Phase 7o: the cap on bench.py's CONFIG at full width in fp32."""
    import torch
    from mom6_torch.drivers import nuopc_cap
    t0 = time.perf_counter()
    cap = nuopc_cap.MOM6Cap().realize(text=cap_text(*MAIN), device=DEV,
                                      dtype=torch.float32)
    build_s = time.perf_counter() - t0
    m = cap.model
    shp = tuple(m.state.h.shape[1:])
    fields = [cap_fields(shp, 100 + i) for i in range(CAP_INTERVALS + 2)]

    def interval(i):
        cap.import_fields(_to(fields[i], DEV, torch.float32))
        cap.advance(CAP_STEPS * m.dt)
        return cap.export_fields()

    interval(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(wrappers)
    ev = [torch.cuda.Event(enable_timing=True)
          for _ in range(CAP_INTERVALS + 1)]
    ev[0].record()
    for i in range(CAP_INTERVALS):
        out = interval(1 + i)
        ev[i + 1].record()
    torch.cuda.synchronize()
    counts = read_counts(wrappers)
    device = {k: wrappers[k].device_launches for k in DEVICE_COUNTED}
    peak = torch.cuda.max_memory_allocated()
    expect = {k: v * CAP_STEPS * CAP_INTERVALS
              for k, v in PER_STEP["hurr"].items()}
    if counts != expect:
        raise AssertionError(f"cap: launches {counts}, expected {expect}")
    check_device_launches("cap", device, counts)
    per = [ev[i].elapsed_time(ev[i + 1]) for i in range(CAP_INTERVALS)]
    check_finite([(k, v[4:-4, 4:-4]) for k, v in out.items()],
                 (shape[0], shape[1] - 8, shape[2] - 8))
    log(f"  build {build_s:.1f} s; {CAP_INTERVALS} intervals of "
        f"{CAP_STEPS} steps: {sum(per) / len(per):.3f} ms an interval "
        f"(CUDA events: import, advance, export; "
        + ", ".join(f"{x:.3f}" for x in per)
        + f"), {sum(per) / len(per) / CAP_STEPS:.3f} ms a step; launches "
        f"{counts}; peak memory {peak / 2**30:.3f} GiB; export SST "
        f"[{float(out['So_t'][4:-4, 4:-4].min()):.4f}, "
        f"{float(out['So_t'][4:-4, 4:-4].max()):.4f}] degC, max |dh/dx| "
        f"{float(out['So_dhdx'].abs().max()):.3e}, boundary layer "
        f"[{float(out['So_bldepth'][4:-4, 4:-4].min()):.2f}, "
        f"{float(out['So_bldepth'][4:-4, 4:-4].max()):.2f}] m")
    one_kernel_per_launch("cap", lambda: interval(CAP_INTERVALS + 1),
                          wrappers, "one interval")
    return dict(ms_interval=sum(per) / len(per), ms_intervals=per,
                launches=counts, peak_bytes=peak)


def run_oda_timed(wrappers):
    """Phase 7p: the ODA ensemble over bench.py's CONFIG at full width
    in fp32, the members stepped in turn."""
    import torch
    from mom6_torch.drivers import ocean_model
    from mom6_torch.oda import driver as oda, ensemble
    m = ocean_model.ocean_model_init(text=cap_text(*MAIN), device=DEV,
                                     dtype=torch.float32)
    H = 4
    ji = (H + MAIN[1] // 2, H + 3 * MAIN[0] // 4)
    t0 = float(m.state.T[0, ji[0], ji[1]])
    obs = [t0 + 0.3 * (c + 1) for c in range(ODA_CYCLES)]
    state_bytes = sum(x.numel() * x.element_size() for x in (
        m.state.h, m.state.u, m.state.v, m.state.T, m.state.S))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    zero_counts(wrappers)
    ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    ev0.record()
    run = oda.run_oda_cycles(m, ensemble.EnsembleCfg(ODA_MEMBERS),
                             ODA_CYCLES, ODA_STEPS, obs, ji, t_pert=0.5,
                             seed=0)
    ev1.record()
    torch.cuda.synchronize()
    counts = read_counts(wrappers)
    device = {k: wrappers[k].device_launches for k in DEVICE_COUNTED}
    peak = torch.cuda.max_memory_allocated()
    n = ODA_MEMBERS * ODA_CYCLES * ODA_STEPS
    expect = {k: v * n for k, v in PER_STEP["hurr"].items()}
    if counts != expect:
        raise AssertionError(f"ODA: launches {counts}, expected {expect}")
    check_device_launches("ODA", device, counts)
    ms = ev0.elapsed_time(ev1)
    check_finite([(f"{k}[{i}]", getattr(run.states, k)[i][..., 4:-4, 4:-4])
                  for k in ("h", "u", "v", "T", "S")
                  for i in range(ODA_MEMBERS)],
                 (MAIN[2], MAIN[1], MAIN[0]))
    log(f"  {ODA_CYCLES} cycles of {ODA_STEPS} steps, {ODA_MEMBERS} "
        f"members: {ms:.1f} ms in all, {ms / n:.3f} ms a member step (CUDA "
        f"events, the EnKF and the cycles' host reads included); launches "
        f"{counts}; peak {peak / 2**30:.3f} GiB (before the run "
        f"{base / 2**30:.3f}, one state's h, u, v, T, S "
        f"{state_bytes / 2**30:.3f}); observations {obs}, SST mean "
        f"{run.sst_mean}, spread {run.sst_spread}")
    return dict(ms_member_step=ms / n, ms_total=ms, launches=counts,
                peak_bytes=peak, base_bytes=base, state_bytes=state_bytes,
                sst_mean=run.sst_mean, sst_spread=run.sst_spread)


def run_particles_case(tmp, wrappers):
    """A copy of cases/double_gyre with PARTICLE_LINES for GYRE_DAYS in
    fp64 on the card, every launch counter zeroed just before and read
    just after, and with --cpu: particles.nc's positions agree to
    1e-12."""
    import numpy as np
    from mom6_torch.drivers import solo
    from mom6_torch.framework.io import read_field
    text = (ROOT / "cases" / "double_gyre" / "MOM_input").read_text() \
        + PARTICLE_LINES
    d_card = case_dir(tmp, "particles_card", text)
    d_cpu = case_dir(tmp, "particles_cpu", text)
    zero_counts(wrappers)
    card = solo.main([d_card, "--days", GYRE_DAYS])
    n = card["steps"]
    launches = check_driver_launches(
        "driver particles", wrappers,
        {k: v * n for k, v in {"K1": 4, "K2": 1, "K3": 2, "K3m": 0}.items()})
    solo.main([d_cpu, "--days", GYRE_DAYS, "--cpu"])
    worst = {}
    for v in ("part_x", "part_y"):
        a = np.asarray(read_field(str(Path(d_cpu) / "particles.nc"), v))
        b = np.asarray(read_field(str(Path(d_card) / "particles.nc"), v))
        if a.shape != b.shape or a.shape[1] != 48:
            raise AssertionError(f"driver particles {v}: shapes {b.shape} "
                                 f"against {a.shape}")
        worst[v] = float(np.abs(a - b).max() / np.abs(a).max())
        if not worst[v] <= 1e-12:
            raise AssertionError(f"driver particles {v}: {worst[v]:.3e}")
    moved = float(np.abs(b[-1] - b[0]).max())
    log(f"  {n} steps, {a.shape[0]} records of {a.shape[1]} particles, "
        f"card against cpu: " + ", ".join(f"{k} {v:.3e}"
                                          for k, v in worst.items())
        + f"; largest move {moved:.4f} cells; driver loop "
        f"{card['loop_seconds'] / n * 1e3:.3f} ms/step; launches {launches}")
    return launches


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


def read_stats(path):
    """[(step, {field: value})] of an ocean.stats file, in file order;
    day and truncs among the fields."""
    return parse_stats("\n".join(
        Path(path).read_text().splitlines()[2:]))


def case_dir(tmp, name, text):
    """A case directory ``name`` under ``tmp`` holding MOM_input."""
    d = Path(tmp) / name
    d.mkdir()
    (d / "MOM_input").write_text(text)
    return str(d)


def zero_counts(wrappers):
    from mom6_torch.core import barotropic_cuda as bc
    from mom6_torch.core import continuity_cuda as cc
    for w in wrappers.values():
        w.launches = 0
    for k in DEVICE_COUNTED:
        wrappers[k].device_launches = 0
    cc.continuity_ppm_cuda.untargeted_launches = 0
    cc.continuity_ppm_cuda.porous_launches = 0
    bc.subcycle_cuda.obc_launches = 0


def check_driver_launches(label, wrappers, expect):
    launches = {k: w.launches for k, w in wrappers.items()}
    if launches != expect:
        raise AssertionError(f"{label}: launch counts {launches}, "
                             f"expected {expect}")
    device = {k: wrappers[k].device_launches for k in DEVICE_COUNTED}
    check_device_launches(label, device, launches)
    return launches


def run_driver_case(tmp, wrappers, case="double_gyre", days=GYRE_DAYS,
                    per_step=None, edits=()):
    """The solo driver on cases/double_gyre (a closed basin, NK = 2,
    K3 with walls in x) for GYRE_DAYS in fp64, or on ``case`` for
    ``days`` with ``per_step`` launches a step, on the card with every
    launch counter zeroed just before and read just after, then with
    --cpu; every ocean.stats field of the two agrees to 1e-9 relative
    (SL and the mass error, roundoff-sized, to 1e-12 absolute) with the
    same truncations.  ``edits``: (old, new) replacements in the case's
    MOM_input."""
    from mom6_torch.drivers import solo
    text = (ROOT / "cases" / case / "MOM_input").read_text()
    for old, new in edits:
        if old not in text:
            raise AssertionError(f"{case}: no {old!r} to edit")
        text = text.replace(old, new)
    d_card = case_dir(tmp, f"{case}_card", text)
    d_cpu = case_dir(tmp, f"{case}_cpu", text)
    zero_counts(wrappers)
    card = solo.main([d_card, "--days", days])
    n = card["steps"]
    per_step = per_step or {"K1": 4, "K2": 1, "K3": 2, "K3m": 0}
    launches = check_driver_launches(
        f"driver {case}", wrappers, {k: v * n for k, v in per_step.items()})
    solo.main([d_cpu, "--days", days, "--cpu"])
    want, got = read_stats(Path(d_cpu) / "ocean.stats"), \
        read_stats(Path(d_card) / "ocean.stats")
    if [s for s, _ in got] != [s for s, _ in want] or len(got) < 3:
        raise AssertionError(f"driver {case}: stats steps "
                             f"{[s for s, _ in got]} against "
                             f"{[s for s, _ in want]}")
    worst = {}
    for (step, w), (_, g) in zip(want, got):
        if g["truncs"] != w["truncs"]:
            raise AssertionError(f"driver {case} step {step}: truncs "
                                 f"{g['truncs']} != {w['truncs']}")
        for k, a in w.items():
            b = g[k]
            # SL and the mass error Me are roundoff-sized: absolute
            absolute = k in ("SL", "Me")
            err = abs(a - b) if absolute else \
                abs(a - b) / max(abs(a), 1e-300) if a != b else 0.0
            lim = 1e-12 if absolute else 1e-9
            worst[k] = max(worst.get(k, 0.0), err)
            if not err <= lim:
                raise AssertionError(f"driver {case} step {step} {k}: "
                                     f"{b!r} against {a!r}")
    log(f"  {n} steps, {len(got)} ocean.stats lines, card against cpu: "
        + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
        + " (SL [m] and Me absolute, the others relative)")
    log(f"  last line (card): En {got[-1][1]['En']!r}, CFL "
        f"{got[-1][1]['CFL']!r}, SL {got[-1][1]['SL']!r}")
    log(f"  nstep chosen by the DTBT resets, step by step: "
        f"{card['nstep_bt']}")
    log(f"  driver loop {card['loop_seconds'] / n * 1e3:.3f} ms/step "
        f"(CUDA events), launches {launches}")
    return launches


def run_driver_bench(tmp, wrappers, shape):
    """bench.py's CONFIG (BT_WIDE_HALO_PERIOD = 2, stats every
    BENCH_STATS_EVERY steps) through the solo driver at 512x512x25 fp32
    for BENCH_STEPS steps, counters zeroed just before and read just
    after; every ocean.stats line finite with |Me| <= 1e-6; then the
    same steps of entry.build_full().step_fn in this process, whose
    final state must equal the driver's bit for bit."""
    import torch
    from mom6_torch import entry
    from mom6_torch.configs import BENCH_CONFIG
    from mom6_torch.diagnostics.depth_list import depth_list_setup
    from mom6_torch.diagnostics.sum_output import collect_stats, stat_sums
    from mom6_torch.drivers import solo
    dt = 600.0
    text = (BENCH_CONFIG + "BT_WIDE_HALO_PERIOD = 2\n"
            f"ENERGYSAVEDAYS = {BENCH_STATS_EVERY * dt / 86400.0!r}\n")
    d = case_dir(tmp, "bench", text)
    days = repr(BENCH_STEPS * dt / 86400.0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(wrappers)
    run = solo.main([d, "--fp32", "--days", days])
    n = run["steps"]
    launches = check_driver_launches(
        "driver bench.py CONFIG", wrappers,
        {"K1": 4 * n, "K2": n, "K3": 0, "K3m": 2 * n})
    peak = torch.cuda.max_memory_allocated()
    if n != BENCH_STEPS or set(run["nstep_bt"]) != {BENCH_NSTEP}:
        raise AssertionError(f"driver bench.py CONFIG: {n} steps with "
                             f"nstep {run['nstep_bt']}, expected "
                             f"{BENCH_STEPS} at {BENCH_NSTEP}")
    rows = read_stats(Path(d) / "ocean.stats")
    if [s for s, _ in rows] != list(range(0, n + 1, BENCH_STATS_EVERY)):
        raise AssertionError(f"driver bench.py CONFIG: stats at steps "
                             f"{[s for s, _ in rows]}")
    for step, row in rows:
        bad = [k for k, v in row.items() if v != v or abs(v) == float("inf")]
        if bad or abs(row["Me"]) > 1e-6:
            raise AssertionError(f"driver bench.py CONFIG step {step}: "
                                 f"{row}")
    log(f"  nstep chosen by the DTBT resets, step by step: "
        f"{run['nstep_bt']}")
    log(f"  ocean.stats (card): " + "; ".join(
        f"step {s} En {r['En']!r} CFL {r['CFL']!r} Me {r['Me']!r}"
        for s, r in rows))
    ms_driver = run["loop_seconds"] / n * 1e3
    st, sp, tr = run["state"], run["split"], run["tracers"]
    del run

    m = entry.build_full(*MAIN, device=DEV, dtype=torch.float32)
    step = m.step_fn()
    cur = [m.state, m.split, m.tracers]
    torch.cuda.synchronize()
    ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    ev0.record()
    for i in range(BENCH_STEPS):
        cur[:] = step(*cur, i)
    ev1.record()
    torch.cuda.synchronize()
    ms_bare = ev0.elapsed_time(ev1) / BENCH_STEPS
    bst, bsp, btr = cur
    pairs = [(k, getattr(st, k), getattr(bst, k))
             for k in ("h", "u", "v", "T", "S")]
    pairs += [("age", tr["age"], btr["age"]), ("eta", sp.eta, bsp.eta)]
    check_finite([(k, a) for k, a, _ in pairs], shape)
    for k, a, b in pairs:
        if not torch.equal(a, b):
            raise AssertionError(f"driver bench.py CONFIG: {k} differs "
                                 "from build_full().step_fn's, max abs "
                                 f"{float((a - b).abs().max()):.3e}")
    log(f"  final h, u, v, T, S, age, eta bitwise equal to "
        f"{BENCH_STEPS} steps of entry.build_full().step_fn")
    dl = depth_list_setup(m.domain, m.grid)
    reps = 5
    collect_stats(stat_sums(m.domain, m.grid, m.vgrid, bst, dt, dl),
                  m.vgrid, 0, 0.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        collect_stats(stat_sums(m.domain, m.grid, m.vgrid, bst, dt, dl),
                      m.vgrid, 0, 0.0)
    ms_stats = (time.perf_counter() - t0) / reps * 1e3
    log(f"  driver loop {ms_driver:.3f} ms/step, bare step_fn loop "
        f"{ms_bare:.3f} ms/step (CUDA events, {BENCH_STEPS} steps each, "
        f"the first included); stat_sums + collect_stats {ms_stats:.3f} "
        f"ms a call (host clock, {reps} calls, synchronized by the host "
        f"copy of the sums); driver peak memory {peak} B "
        f"({peak / 2**30:.3f} GiB, max_memory_allocated)")
    return launches


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
    import numpy
    import scipy
    log(f"phase 1 device: {kind}, count {torch.cuda.device_count()}; "
        f"python {sys.version.split()[0]}, torch {torch.__version__} "
        f"(CUDA {torch.version.cuda}), numpy {numpy.__version__}, "
        f"scipy {scipy.__version__}")

    # 2. build
    from mom6_torch import cuda_build
    t0 = time.perf_counter()
    logs = cuda_build.build()
    log(f"phase 2 build: {time.perf_counter() - t0:.1f} s "
        f"({', '.join(cuda_build.SOURCES)})")
    log_resources(logs.get("continuity", ""), "sweep_kernel")
    log_resources(logs.get("continuity", ""), "bt_cont_kernel")
    subcycle_ptxas = subcycle_resources(
        log_resources(logs.get("barotropic", ""), "subcycle_kernel"))
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
    log("phase 3 closed basin (walls in x): K1, K2, K3 vs plain, exact")
    for dtype in (torch.float64, torch.float32):
        for shape in (GYRE, MAIN):
            check_k1_k2(res, *shape, dtype, reentrant_x=False, exact=True)
            check_k3(res, *shape, dtype, reentrant_x=False, exact=True)
    torch.cuda.empty_cache()
    log("phase 3 K1/K2 modes vs plain, exact: "
        + ", ".join(MODES))
    mode_timing = {}
    for dtype in (torch.float64, torch.float32):
        for shape in (MAIN, GYRE):
            main_shape = dtype == torch.float32 and shape == MAIN
            check_modes(res, *shape, dtype,
                        mode_timing if main_shape else None,
                        reentrant_x=shape != GYRE)
    log("phase 3 porous faces: K1 (both orders, matched and untargeted) "
        "and K2 vs plain, exact")
    for dtype in (torch.float64, torch.float32):
        for shape in (MAIN, GYRE):
            main_shape = dtype == torch.float32 and shape == MAIN
            check_porous(res, *shape, dtype,
                         mode_timing if main_shape else None,
                         reentrant_x=shape != GYRE)
    modes = mode_records(res, mode_timing,
                         (MAIN[2], MAIN[1] + 8, MAIN[0] + 8))
    del mode_timing
    log("phase 3 K3 and K3m under BT_STRONG_DRAG and BOUND_BT_CORRECTION "
        "vs plain")
    for dtype in (torch.float64, torch.float32):
        check_bt_options(res, *MAIN, dtype)
    torch.cuda.empty_cache()
    import tempfile
    log("phase 3 open boundaries: K3's open-face instance vs plain, and K1 "
        "on OBC-extended halos, exact")
    with tempfile.TemporaryDirectory() as tmp:
        for dtype in (torch.float64, torch.float32):
            for shape in (MAIN, GYRE):
                main_shape = dtype == torch.float32 and shape == MAIN
                check_k3_obc(res, *shape, dtype, tmp,
                             timing if main_shape else None)
                check_k1_obc(res, *shape, dtype, tmp)
    torch.cuda.empty_cache()
    ms, plain_ms, inp = timing.pop("K3 wide")
    b_ms, b_by = bound(*subcycle_work(inp), 4, "float32")
    log(f"  K3 at {inp.eta.shape[0]}x{inp.eta.shape[1]} fp32 curve "
        f"({bc_plan(inp)}, {inp.wts.shape[1]} substeps): {ms:.4f} ms per "
        f"subcycle, bound {b_ms:.4f} ms ({b_by}), plain {plain_ms:.4f} ms")
    del inp

    # the device kernels of each kernel's calls, traced before the long
    # phases
    log("phase 3 torch.profiler traces of K1, K2, K3, K3m and K3o at the "
        "main path's shape")
    from mom6_torch.core import barotropic_cuda, continuity_cuda
    wrappers = {"K1": continuity_cuda.continuity_ppm_cuda,
                "K2": continuity_cuda.set_up_bt_cont_cuda,
                "K3": barotropic_cuda.subcycle_cuda,
                "K3m": barotropic_cuda.subcycle_march_cuda}
    traces = trace_kernels(timing, wrappers)

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
    from mom6_torch.core.dynamics_split_rk2 import step_dyn_split_rk2

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

    # 6b. RK2b (period 1 and 2) and unsplit RK3 at 32x32x6 fp64
    for label, dyn, period, n in (("RK2b period 1", "rk2b", 1, 4),
                                  ("RK2b period 2", "rk2b", 2, 4),
                                  ("unsplit RK3", "unsplit", 2, 6)):
        log(f"phase 6b {label} %dx%dx%d fp64, {n} steps: card vs cpu"
            % SMALL_FULL)
        zero_counts(wrappers)
        gst, gsp, gtr = run_full(*SMALL_FULL, torch.float64, DEV, n, seed=3,
                                 regridding=True, dynamics=dyn,
                                 period=period)
        counts = read_counts(wrappers)
        cst, csp, ctr = run_full(*SMALL_FULL, torch.float64, "cpu", n,
                                 seed=3, regridding=True, dynamics=dyn,
                                 period=period)
        pairs = [("h", cst.h, gst.h), ("u", cst.u, gst.u),
                 ("v", cst.v, gst.v), ("T", cst.T, gst.T),
                 ("S", cst.S, gst.S), ("age", ctr["age"], gtr["age"])]
        if csp is not None:
            pairs += [("eta", csp.eta, gsp.eta),
                      ("du_av_inst", csp.du_av_inst, gsp.du_av_inst),
                      ("dv_av_inst", csp.dv_av_inst, gsp.dv_av_inst)]
        for name, a, b in pairs:
            rel, diff = rel_err(a, b.cpu())
            log(f"  {label} {name}: max rel err {rel:.3e} (limit 1e-09)")
            if not rel <= 1e-9:
                raise AssertionError(f"{label} {name}: {rel:.3e} > 1e-9")
        expect = {k: v * n for k, v in PER_STEP[dyn].items()}
        if period == 1:
            expect.update(K3=expect["K3m"], K3m=0)
        if counts != expect:
            raise AssertionError(f"{label}: launches {counts}, expected "
                                 f"{expect}")
        log(f"  {label} on the card: launches {counts}")

    # 6c. the first breadth item's two texts at 32x32x6 fp64
    for label, dyn in (("B1", "b1"), ("non-Boussinesq", "nonbouss")):
        n = 4
        log(f"phase 6c {label} (configs.BENCH_CONFIG_"
            f"{dyn.upper()}) %dx%dx%d fp64, {n} steps: card vs cpu"
            % SMALL_FULL)
        zero_counts(wrappers)
        gst, gsp, gtr = run_full(*SMALL_FULL, torch.float64, DEV, n, seed=3,
                                 regridding=True, dynamics=dyn)
        counts = read_counts(wrappers)
        cst, csp, ctr = run_full(*SMALL_FULL, torch.float64, "cpu", n,
                                 seed=3, regridding=True, dynamics=dyn)
        for name, a, b in (("h", cst.h, gst.h), ("u", cst.u, gst.u),
                           ("v", cst.v, gst.v), ("T", cst.T, gst.T),
                           ("S", cst.S, gst.S),
                           ("age", ctr["age"], gtr["age"]),
                           ("eta", csp.eta, gsp.eta),
                           ("u_av", csp.u_av, gsp.u_av)):
            rel, diff = rel_err(a, b.cpu())
            log(f"  {label} {name}: max rel err {rel:.3e} (limit 1e-09)")
            if not rel <= 1e-9:
                raise AssertionError(f"{label} {name}: {rel:.3e} > 1e-9")
        expect = {k: v * n for k, v in PER_STEP[dyn].items()}
        if counts != expect:
            raise AssertionError(f"{label}: launches {counts}, expected "
                                 f"{expect}")
        log(f"  {label} on the card: launches {counts}")
    fp32_departure(4)

    # 6d. open boundaries at 32x32x6 fp64
    from mom6_torch import configs
    seg_text = (configs.BENCH_CONFIG + "#override REENTRANT_X = False\n"
                + "".join(ln + "\n" for ln in configs.OBC_LINES.splitlines()
                          if ln.startswith(("OBC_NUMBER", "OBC_SEGMENT"))))
    for label, text, n in (("BENCH_CONFIG_OBC", configs.BENCH_CONFIG_OBC, 4),
                           ("bench.py CONFIG with segments", seg_text, 2)):
        log(f"phase 6d {label} %dx%dx%d fp64, {n} steps: card vs cpu"
            % SMALL_FULL)
        zero_counts(wrappers)
        with tempfile.TemporaryDirectory() as tmp:
            gst, gsp, gtr, gres = run_text(text, *SMALL_FULL, torch.float64,
                                           DEV, n, 3, tmp)
        counts = read_counts(wrappers)
        with tempfile.TemporaryDirectory() as tmp:
            cst, csp, ctr, cres = run_text(text, *SMALL_FULL, torch.float64,
                                           "cpu", n, 3, tmp)
        pairs = [(k, getattr(cst, k), getattr(gst, k))
                 for k in ("h", "u", "v", "T", "S")
                 if getattr(cst, k) is not None]
        pairs += [(k, ctr[k], gtr[k]) for k in sorted(ctr)]
        pairs += [(k, getattr(csp, k), getattr(gsp, k))
                  for k in ("eta", "u_av", "v_av")]
        for name, a, b in pairs:
            rel, diff = rel_err(a, b.cpu())
            log(f"  {label} {name}: max rel err {rel:.3e} (limit 1e-09)")
            if not rel <= 1e-9:
                raise AssertionError(f"{label} {name}: {rel:.3e} > 1e-9")
        worst = max(float((cres[k][e] - gres[k][e].cpu()).abs().max())
                    for k in cres for e in cres[k])
        log(f"  {label} reservoirs: max abs err {worst:.3e} (limit 1e-09)")
        if not worst <= 1e-9:
            raise AssertionError(f"{label} reservoirs: {worst:.3e}")
        if counts["K3o"] != counts["K3"] or counts["K3"] != 2 * n \
                or counts["K2"] or counts["K3m"]:
            raise AssertionError(f"{label}: launches {counts}")
        log(f"  {label} on the card: launches {counts}")

    # 6e. the rest of the first breadth item at 32x32x6 fp64
    n = 4
    log("phase 6e stoch (configs.BENCH_CONFIG_STOCH: THICKNESSDIFFUSE_FIRST,"
        " DIABATIC_FIRST, GME, STOCH_EOS, SPPT, SKEB; Z* ALE) "
        "%dx%dx%d fp64, " % SMALL_FULL + f"{n} steps: card vs cpu")
    zero_counts(wrappers)
    gst, gsp, gtr, gcarry = run_full(*SMALL_FULL, torch.float64, DEV, n,
                                     seed=3, regridding=True,
                                     dynamics="stoch", with_carry=True)
    counts = read_counts(wrappers)
    cst, csp, ctr, ccarry = run_full(*SMALL_FULL, torch.float64, "cpu", n,
                                     seed=3, regridding=True,
                                     dynamics="stoch", with_carry=True)
    pairs = [(k, getattr(cst, k), getattr(gst, k))
             for k in ("h", "u", "v", "T", "S")]
    pairs += [("age", ctr["age"], gtr["age"]), ("eta", csp.eta, gsp.eta),
              ("u_av", csp.u_av, gsp.u_av)]
    pairs += [(f"pattern {k}", ccarry["sppt"][k], gcarry["sppt"][k])
              for k in ("sppt", "skeb")]
    for name, a, b in pairs:
        rel, diff = rel_err(a, b.cpu())
        log(f"  stoch {name}: max rel err {rel:.3e} (limit 1e-09)")
        if not rel <= 1e-9:
            raise AssertionError(f"stoch {name}: {rel:.3e} > 1e-9")
    expect = {k: v * n for k, v in PER_STEP["stoch"].items()}
    if counts != expect:
        raise AssertionError(f"stoch: launches {counts}, expected {expect}")
    log(f"  stoch on the card: launches {counts}")

    # 6f. the column physics of the third breadth item at 32x32x6 fp64,
    # then 6g. the lateral parameterizations of the fourth
    for phase, label, dyn, extra in (
            ("6f", "B3", "b3", COLUMN), ("6f", "B3 with PP81", "b3pp81", COLUMN),
            ("6f", "BML", "bml", COLUMN), ("6g", "B4", "b4", ""),
            ("6g", "B4V", "b4v", COLUMN)):
        n = 4
        thin = dyn in ("bml", "b4v")        # layered, thin layers
        log(f"phase {phase} {label} (build_full(dynamics={dyn!r})"
            + (", a weakly stratified 400 m column" if extra else "")
            + ") %dx%dx%d fp64, " % SMALL_FULL + f"{n} steps: card vs cpu")
        zero_counts(wrappers)
        gst, gsp, gtr, gcarry = run_full(*SMALL_FULL, torch.float64, DEV, n,
                                         seed=3, regridding=True,
                                         dynamics=dyn, with_carry=True,
                                         extra=extra)
        counts = read_counts(wrappers)
        cst, csp, ctr, ccarry = run_full(*SMALL_FULL, torch.float64, "cpu",
                                         n, seed=3, regridding=True,
                                         dynamics=dyn, with_carry=True,
                                         extra=extra)
        conc = [("T", cst.T, gst.T), ("S", cst.S, gst.S),
                ("age", ctr["age"], gtr["age"])]
        pairs = [(k, getattr(cst, k), getattr(gst, k))
                 for k in ("h", "u", "v", "frazil", "meke")
                 if getattr(cst, k) is not None]
        if ccarry.get("iten") is not None:
            # the modal speeds of a column with a statically unstable
            # interface (the seeded T noise makes some) come from 10
            # inverse iterations that have not converged, so they follow
            # the last bits (ROADMAP.md Queue 3: a 1e-15 nudge of T on the
            # CPU moves them by 9.4e-6 and En by 6.1e-7 after 4 steps):
            # En is printed and its total over the compute domain held
            a, b = ccarry["iten"], gcarry["iten"].cpu()
            rel, _ = rel_err(a, b)
            log(f"  {label} int_tide_en carry: max rel err {rel:.3e} "
                "(printed)")
            ta, tb = (float(x[..., 4:-4, 4:-4].sum()) for x in (a, b))
            rel = abs(ta - tb) / abs(ta)
            log(f"  {label} int_tide_en carry, its total: {ta!r} J m-2 "
                f"summed, rel err {rel:.3e} (limit 1e-09)")
            if not rel <= 1e-9:
                raise AssertionError(f"{label} int_tide_en total: "
                                     f"{rel:.3e} > 1e-9")
        if thin:
            # the bulk mixed layer and the entrainment leave layers of a
            # few metres down to 1e-10 m, whose concentrations turn the
            # last bits into ~1e-8 (a 2e-16 nudge of T on the CPU moves
            # T by 6.6e-9, h T by 4.9e-11; ROADMAP.md Queue 3): the
            # contents are held, the concentrations printed
            for name, a, b in conc:
                rel, _ = rel_err(a, b.cpu())
                log(f"  {label} {name}: max rel err {rel:.3e} (printed)")
            conc = [(f"h {k}", cst.h * a, gst.h * b) for k, a, b in conc]
        pairs += conc + [("eta", csp.eta, gsp.eta),
                         ("u_av", csp.u_av, gsp.u_av)]
        if ccarry["kv"] is not None:
            kv_c, kv_g = ccarry["kv"], gcarry["kv"].cpu()
            if thin:
                # so does LMD94's shear viscosity across those layers: it
                # is held between layers thicker than 1 m (2.1e-11 in that
                # CPU nudge, 4.3e-7 with the thin ones)
                rel, _ = rel_err(kv_c, kv_g)
                log(f"  {label} kv_shear carry: max rel err {rel:.3e} "
                    "(printed)")
                thick = torch.zeros_like(kv_c, dtype=torch.bool)
                thick[1:-1] = (cst.h[:-1] > 1.0) & (cst.h[1:] > 1.0)
                kv_c, kv_g = kv_c * thick, kv_g * thick
            if dyn == "b4v":
                # under the Visbeck and epipycnal diffusion even those move
                # with the last bits: a 1e-15 nudge of T on the CPU moves
                # them by 5.3e-9 (ROADMAP.md Queue 3); printed, the
                # velocities they act on held
                rel, _ = rel_err(kv_c, kv_g)
                log(f"  {label} kv_shear carry between layers over 1 m: max "
                    f"rel err {rel:.3e} (printed)")
            else:
                pairs.append(("kv_shear carry" + (" between layers over 1 m"
                                                  if thin else ""),
                              kv_c, kv_g))
        if ccarry["mld"] is not None:
            # ePBL's MLD is the deepest interface whose mixing cost the
            # TKE affords: where the two are within roundoff, the last
            # bits flip it between interfaces (ROADMAP.md Queue 3).  The
            # last step is thermodynamic, so no step has used it yet
            a = ccarry["mld"][4:-4, 4:-4]
            d = (a - gcarry["mld"].cpu()[4:-4, 4:-4]).abs()
            tie = d > 1e-9 * a.abs().max()
            flips = int(tie.sum())
            rest = float(d[~tie].max()) if flips < d.numel() else 0.0
            log(f"  {label} mld carry: {flips} of {d.numel()} columns apart "
                "by more than 1e-9 of the largest (affordability ties); "
                f"the rest within {rest:.3e} m")
            if flips > 0.05 * d.numel():
                raise AssertionError(f"{label} mld carry: {flips} columns "
                                     "apart")
        for name, a, b in pairs:
            rel, diff = rel_err(a, b.cpu())
            log(f"  {label} {name}: max rel err {rel:.3e} (limit 1e-09)")
            if not rel <= 1e-9:
                raise AssertionError(f"{label} {name}: {rel:.3e} > 1e-9")
        if gcarry["kv"] is not None:
            log(f"  {label}: max kv_shear {float(gcarry['kv'].max()):.4e} "
                "m2/s on the card")
        if gst.meke is not None:
            log(f"  {label}: MEKE energy in [{float(gst.meke.min()):.4e}, "
                f"{float(gst.meke.max()):.4e}] m2 s-2, internal-tide "
                f"energy max {float(gcarry['iten'].max()):.4e} J m-2 on "
                "the card")
        expect = {k: v * n for k, v in PER_STEP[dyn].items()}
        if counts != expect:
            raise AssertionError(f"{label}: launches {counts}, expected "
                                 f"{expect}")
        log(f"  {label} on the card: launches {counts}")

    # 6h. the other equations of state and the hybrid coordinates of the
    # fifth and sixth breadth items at 32x32x6 fp64, card against CPU;
    # then fp32 against fp64 on the card
    for label, dyn in (("HYBGEN", "hybgen"), ("ADAPT", "adapt"),
                       ("UNMIX", "unmix")):
        n = 3
        log(f"phase 6h {label} (configs.BENCH_CONFIG_{label}) %dx%dx%d "
            "fp64, " % SMALL_FULL + f"{n} steps: card vs cpu")
        zero_counts(wrappers)
        gst, gsp, gtr = run_full(*SMALL_FULL, torch.float64, DEV, n, seed=3,
                                 regridding=True, dynamics=dyn)
        counts = read_counts(wrappers)
        cst, csp, ctr = run_full(*SMALL_FULL, torch.float64, "cpu", n,
                                 seed=3, regridding=True, dynamics=dyn)
        for name, a, b in (("h", cst.h, gst.h), ("u", cst.u, gst.u),
                           ("v", cst.v, gst.v), ("T", cst.T, gst.T),
                           ("S", cst.S, gst.S),
                           ("age", ctr["age"], gtr["age"]),
                           ("eta", csp.eta, gsp.eta), ("uh", csp.uh, gsp.uh),
                           ("vh", csp.vh, gsp.vh)):
            rel, diff = rel_err(a, b.cpu())
            log(f"  {label} {name}: max rel err {rel:.3e} (limit 1e-09)")
            if not rel <= 1e-9:
                raise AssertionError(f"{label} {name}: {rel:.3e} > 1e-9")
        expect = {k: v * n for k, v in PER_STEP[dyn].items()}
        if counts != expect:
            raise AssertionError(f"{label}: launches {counts}, expected "
                                 f"{expect}")
        log(f"  {label} on the card: launches {counts}")
        fst, fsp, ftr = run_full(*SMALL_FULL, torch.float32, DEV, n, seed=3,
                                 regridding=True, dynamics=dyn)
        check_finite((("h", fst.h[:, 4:-4, 4:-4]),
                      ("T", fst.T[:, 4:-4, 4:-4]),
                      ("u", fst.u[:, 4:-4, 4:-4])),
                     fst.h[:, 4:-4, 4:-4].shape)
        log(f"  {label}: fp32 against fp64 on the card after {n} steps, max "
            "rel err " + ", ".join(
                f"{k} {rel_err(getattr(gst, k), getattr(fst, k))[0]:.3e}"
                for k in ("h", "u", "v", "T", "S"))
            + f", eta {rel_err(gsp.eta, fsp.eta)[0]:.3e} (printed)")
    # 6i. every equation of state and the hybrid modules, card against CPU
    log("phase 6i every EQN_OF_STATE form, card vs cpu fp64")
    check_eos_forms()
    log("phase 6i hybgen, unmixing, ADAPTIVE and the hybgen remap schemes, "
        "card vs cpu fp64")
    check_hybrid_modules()
    # 6x. the ninth breadth item's text at 32x32x6 fp64, then its modules
    n = 3
    log("phase 6x FILE (configs.BENCH_CONFIG_FILE) %dx%dx%d fp64, " % SMALL_FULL
        + f"{n} steps: card vs cpu")
    zero_counts(wrappers)
    gst, gsp, gtr = run_full(*SMALL_FULL, torch.float64, DEV, n, seed=3,
                             regridding=True, dynamics="file")
    counts = read_counts(wrappers)
    cst, csp, ctr = run_full(*SMALL_FULL, torch.float64, "cpu", n, seed=3,
                             regridding=True, dynamics="file")
    worst_file = 0.0
    for name, a, b in (("h", cst.h, gst.h), ("u", cst.u, gst.u),
                       ("v", cst.v, gst.v), ("T", cst.T, gst.T),
                       ("S", cst.S, gst.S), ("age", ctr["age"], gtr["age"]),
                       ("eta", csp.eta, gsp.eta), ("uh", csp.uh, gsp.uh),
                       ("vh", csp.vh, gsp.vh)):
        rel, diff = rel_err(a, b.cpu())
        worst_file = max(worst_file, rel)
        log(f"  FILE {name}: max rel err {rel:.3e} (limit 1e-09)")
        if not rel <= 1e-9:
            raise AssertionError(f"FILE {name}: {rel:.3e} > 1e-9")
    expect = {k: v * n for k, v in PER_STEP["file"].items()}
    if counts != expect:
        raise AssertionError(f"FILE: launches {counts}, expected {expect}")
    log(f"  FILE on the card: launches {counts}, largest rel err "
        f"{worst_file:.3e}")
    log("phase 6x the file-driven modules, card vs cpu fp64")
    check_file_modules()
    # 6y. the seventh breadth item's text at 32x32x6 fp64, then its modules
    n = 3
    log("phase 6y BGC (configs.BENCH_CONFIG_BGC) %dx%dx%d fp64, " % SMALL_FULL
        + f"{n} steps: card vs cpu")
    zero_counts(wrappers)
    gst, gsp, gtr = run_full(*SMALL_FULL, torch.float64, DEV, n, seed=3,
                             regridding=True, dynamics="bgc")
    counts = read_counts(wrappers)
    cst, csp, ctr = run_full(*SMALL_FULL, torch.float64, "cpu", n, seed=3,
                             regridding=True, dynamics="bgc")
    worst_bgc = {}
    for name, a, b in ([(k, getattr(cst, k), getattr(gst, k))
                        for k in ("h", "u", "v", "T", "S")]
                       + [(k, getattr(csp, k), getattr(gsp, k))
                          for k in ("eta", "uh", "vh")]
                       + [(k, ctr[k], gtr[k]) for k in ctr]):
        worst_bgc[name] = rel_err(a, b.cpu())[0]
    log("  BGC card vs cpu max rel err (limit 2.5e-12): " + ", ".join(
        f"{k} {v:.3e}" for k, v in worst_bgc.items()))
    bad = {k: v for k, v in worst_bgc.items() if not v <= 2.5e-12}
    if bad:
        raise AssertionError(f"BGC card vs cpu above 2.5e-12: {bad}")
    expect = {k: v * n for k, v in PER_STEP["bgc"].items()}
    if counts != expect:
        raise AssertionError(f"BGC: launches {counts}, expected {expect}")
    log(f"  BGC on the card: {len(gtr)} tracers, launches {counts}, "
        f"largest rel err {max(worst_bgc.values()):.3e}")
    log("phase 6y the tracer packages, the BGC coupler, NPZD, the restoring "
        "and step_offline, card vs cpu fp64")
    check_bgc_modules()
    # 6z. the eighth breadth item's text at 32x32x6 fp64, then the shelf's
    # modules and the shelf-only driver
    log("phase 6z SHELF (configs.BENCH_CONFIG_SHELF) %dx%dx%d fp64, "
        % SMALL_FULL + f"{n} steps: card vs cpu")
    zero_counts(wrappers)
    gst, gsp, gtr = run_full(*SMALL_FULL, torch.float64, DEV, n, seed=3,
                             regridding=True, dynamics="shelf")
    counts = read_counts(wrappers)
    cst, csp, ctr = run_full(*SMALL_FULL, torch.float64, "cpu", n, seed=3,
                             regridding=True, dynamics="shelf")
    worst_shelf = {}
    for name, a, b in ([(k, getattr(cst, k), getattr(gst, k))
                        for k in ("h", "u", "v", "T", "S")]
                       + [(k, getattr(csp, k), getattr(gsp, k))
                          for k in ("eta", "uh", "vh")]
                       + [(k, ctr[k], gtr[k]) for k in ctr]):
        worst_shelf[name] = rel_err(a, b.cpu())[0]
    log("  SHELF card vs cpu max rel err (limit 2.5e-12): " + ", ".join(
        f"{k} {v:.3e}" for k, v in worst_shelf.items()))
    bad = {k: v for k, v in worst_shelf.items() if not v <= 2.5e-12}
    if bad:
        raise AssertionError(f"SHELF card vs cpu above 2.5e-12: {bad}")
    expect = {k: v * n for k, v in PER_STEP["shelf"].items()}
    if counts != expect:
        raise AssertionError(f"SHELF: launches {counts}, expected {expect}")
    log(f"  SHELF on the card: launches {counts}")
    log("phase 6z three_equation_melt, the SSA solve, step_shelf and the "
        "shelf-only driver, card vs cpu fp64")
    with tempfile.TemporaryDirectory() as tmp:
        check_shelf_modules(tmp)
    # 6t. the rest of the tenth breadth item
    log("phase 6t the forcing library (HURR's hurricane, its single-column "
        "and BR-benchmark variants, the CVMix tests' wind and fluxes, BFB, "
        "the dumbbell), card vs cpu fp64 %dx%dx%d" % SMALL_FULL)
    check_tenth(wrappers)

    # 7. slice 2 at full width, fp32, with ALE and layered
    full = {}
    for label, regridding in FULL_VARIANTS:
        log(f"phase 7 slice 2 ({label}) %dx%dx%d fp32" % MAIN)
        full[label] = run_full_timed(label, regridding, nsteps, wrappers,
                                     shape)
        torch.cuda.empty_cache()
    launches, device = full["ale"]["launches"], full["ale"]["device"]
    # the states' shape, then the states go: the later phases' peaks
    # hold only their own
    shape_main = full["ale"]["state"].h.shape
    for v in full.values():
        del v["state"]
    d_ms = {k: v["ms_step"] for k, v in full.items()}
    log(f"  ALE against layered: {d_ms['ale'] - d_ms['layered']:.3f} "
        "ms/step (CUDA events; the counterpart of bench.py's "
        "ale_regrid_remap probe), peak memory "
        + ", ".join(f"{k} {v['peak_bytes'] / 2**30:.3f} GiB"
                    for k, v in full.items()))

    # 7b. RK2b and unsplit at full width, fp32
    for dyn in ("rk2b", "unsplit"):
        log(f"phase 7b {dyn} (build_full(dynamics={dyn!r}), Z* ALE) "
            "%dx%dx%d fp32" % MAIN)
        full[dyn] = run_new_timed(dyn, wrappers, shape)
        torch.cuda.empty_cache()

    # 7c. the first breadth item's two texts at full width, fp32
    for dyn in ("b1", "nonbouss"):
        log(f"phase 7c {dyn} (configs.BENCH_CONFIG_{dyn.upper()}, Z* ALE) "
            "%dx%dx%d fp32" % MAIN)
        full[dyn] = run_new_timed(dyn, wrappers, shape,
                                  b1_extra if dyn == "b1" else None)
        torch.cuda.empty_cache()

    # 7d. open boundaries at full width, fp32
    log("phase 7d obc (configs.BENCH_CONFIG_OBC, layered, adiabatic) "
        "%dx%dx%d fp32" % MAIN)
    full["obc"] = run_new_timed("obc", wrappers, shape, obc_extra)
    torch.cuda.empty_cache()

    # 7e. the rest of the first breadth item at full width, fp32
    log("phase 7e stoch (configs.BENCH_CONFIG_STOCH, Z* ALE) "
        "%dx%dx%d fp32" % MAIN)
    full["stoch"] = run_new_timed("stoch", wrappers, shape, stoch_extra)
    log(f"  stoch against bench.py's CONFIG (phase 7, Z* ALE, same "
        f"process): {full['stoch']['ms_step']:.3f} against "
        f"{full['ale']['ms_step']:.3f} ms/step; peak "
        f"{full['stoch']['peak_bytes'] / 2**30:.3f} against "
        f"{full['ale']['peak_bytes'] / 2**30:.3f} GiB")
    torch.cuda.empty_cache()

    # 7f. the column physics of the third breadth item at full width
    for dyn in ("b3", "bml"):
        log(f"phase 7f {dyn} (configs.BENCH_CONFIG_{dyn.upper()}, "
            + ("Z* ALE" if dyn == "b3" else "layered") + ") %dx%dx%d fp32"
            % MAIN)
        full[dyn] = run_new_timed(dyn, wrappers, shape, column_extra)
        torch.cuda.empty_cache()
    log(f"  b3 against bench.py's CONFIG (phase 7, Z* ALE) and bml against "
        f"its layered variant, same process: {full['b3']['ms_step']:.3f} "
        f"against {full['ale']['ms_step']:.3f} and "
        f"{full['bml']['ms_step']:.3f} against "
        f"{full['layered']['ms_step']:.3f} ms/step")

    # 7g. the lateral parameterizations of the fourth breadth item at full
    # width
    for dyn in ("b4", "b4v"):
        log(f"phase 7g {dyn} (configs.BENCH_CONFIG_{dyn.upper()}, "
            + ("Z* ALE" if dyn == "b4" else "layered") + ") %dx%dx%d fp32"
            % MAIN)
        full[dyn] = run_new_timed(dyn, wrappers, shape, lateral_extra)
        torch.cuda.empty_cache()
    log(f"  b4 against bench.py's CONFIG (phase 7, Z* ALE) and b4v against "
        f"bml (phase 7f), same process: {full['b4']['ms_step']:.3f} "
        f"against {full['ale']['ms_step']:.3f} and "
        f"{full['b4v']['ms_step']:.3f} against "
        f"{full['bml']['ms_step']:.3f} ms/step; peak "
        f"{full['b4']['peak_bytes'] / 2**30:.3f} against "
        f"{full['ale']['peak_bytes'] / 2**30:.3f} and "
        f"{full['b4v']['peak_bytes'] / 2**30:.3f} against "
        f"{full['bml']['peak_bytes'] / 2**30:.3f} GiB")

    # 7h. the hybrid coordinates at full width
    for dyn in ("hybgen", "adapt"):
        log(f"phase 7h {dyn} (configs.BENCH_CONFIG_{dyn.upper()}) "
            "%dx%dx%d fp32" % MAIN)
        full[dyn] = run_new_timed(dyn, wrappers, shape, hybrid_extra)
        torch.cuda.empty_cache()
    log(f"  hybgen and adapt against bench.py's CONFIG (phase 7, Z* ALE), "
        f"same process: {full['hybgen']['ms_step']:.3f} and "
        f"{full['adapt']['ms_step']:.3f} against "
        f"{full['ale']['ms_step']:.3f} ms/step; peak "
        f"{full['hybgen']['peak_bytes'] / 2**30:.3f} and "
        f"{full['adapt']['peak_bytes'] / 2**30:.3f} against "
        f"{full['ale']['peak_bytes'] / 2**30:.3f} GiB")

    # 7i. set up and forced from files at full width
    log("phase 7i file (configs.BENCH_CONFIG_FILE) %dx%dx%d fp32" % MAIN)
    full["file"] = run_new_timed("file", wrappers, shape, file_extra)
    torch.cuda.empty_cache()
    log(f"  file against bench.py's CONFIG (phase 7, Z* ALE), same "
        f"process: {full['file']['ms_step']:.3f} against "
        f"{full['ale']['ms_step']:.3f} ms/step ("
        + ", ".join(f"{k} {v:.3f} against {full['ale']['by_kind'][k]:.3f}"
                    for k, v in full["file"]["by_kind"].items())
        + f"); peak {full['file']['peak_bytes'] / 2**30:.3f} against "
        f"{full['ale']['peak_bytes'] / 2**30:.3f} GiB")

    # 7j. biogeochemistry at full width, then 7k, offline mode, from it
    log("phase 7j bgc (configs.BENCH_CONFIG_BGC, Z* ALE, 13 passive "
        "tracers) %dx%dx%d fp32" % MAIN)
    full["bgc"] = run_new_timed("bgc", wrappers, shape, functools.partial(
        bgc_extra, wrappers=wrappers))
    torch.cuda.empty_cache()
    log(f"  bgc against bench.py's CONFIG (phase 7, Z* ALE), same "
        f"process: {full['bgc']['ms_step']:.3f} against "
        f"{full['ale']['ms_step']:.3f} ms/step ("
        + ", ".join(f"{k} {v:.3f} against {full['ale']['by_kind'][k]:.3f}"
                    for k, v in full["bgc"]["by_kind"].items())
        + f"); peak {full['bgc']['peak_bytes'] / 2**30:.3f} against "
        f"{full['ale']['peak_bytes'] / 2**30:.3f} GiB")

    # 7l. the ice shelf at full width, beside bench.py's CONFIG of phase 7
    log("phase 7l shelf (configs.BENCH_CONFIG_SHELF, Z* ALE, walls in x) "
        "%dx%dx%d fp32" % MAIN)
    full["shelf"] = run_new_timed("shelf", wrappers, shape, shelf_extra)
    torch.cuda.empty_cache()
    log(f"  shelf against bench.py's CONFIG (phase 7, Z* ALE), same "
        f"process: {full['shelf']['ms_step']:.3f} against "
        f"{full['ale']['ms_step']:.3f} ms/step ("
        + ", ".join(f"{k} {v:.3f} against {full['ale']['by_kind'][k]:.3f}"
                    for k, v in full["shelf"]["by_kind"].items())
        + f"); peak {full['shelf']['peak_bytes'] / 2**30:.3f} against "
        f"{full['ale']['peak_bytes'] / 2**30:.3f} GiB")
    # 7m. the shelf-only step at full width
    log("phase 7m the shelf-only step (drivers/shelf_solo.py) 512x512 "
        f"fp64, {SHELF_SOLO_STEPS} steps")
    with tempfile.TemporaryDirectory() as tmp:
        shelf_solo = run_shelf_solo(tmp, wrappers)
    torch.cuda.empty_cache()

    # 7n. the hurricane at full width, beside bench.py's CONFIG of phase 7
    log("phase 7n hurr (configs.BENCH_CONFIG_HURR, Z* ALE) %dx%dx%d fp32"
        % MAIN)
    t0 = time.perf_counter()
    full["hurr"] = run_new_timed("hurr", wrappers, shape, hurr_extra)
    torch.cuda.empty_cache()
    log(f"  hurr against bench.py's CONFIG (phase 7, Z* ALE), same "
        f"process: {full['hurr']['ms_step']:.3f} against "
        f"{full['ale']['ms_step']:.3f} ms/step ("
        + ", ".join(f"{k} {v:.3f} against {full['ale']['by_kind'][k]:.3f}"
                    for k, v in full["hurr"]["by_kind"].items())
        + f"); peak {full['hurr']['peak_bytes'] / 2**30:.3f} against "
        f"{full['ale']['peak_bytes'] / 2**30:.3f} GiB; phase "
        f"{time.perf_counter() - t0:.1f} s")
    # 7o. the NUOPC-shaped cap at full width
    log(f"phase 7o the cap (drivers/nuopc_cap.py) on bench.py's CONFIG "
        f"%dx%dx%d fp32, {CAP_STEPS} steps an interval" % MAIN)
    t0 = time.perf_counter()
    cap_run = run_cap_timed(wrappers, shape)
    torch.cuda.empty_cache()
    log(f"  phase {time.perf_counter() - t0:.1f} s")
    # 7p. the ODA ensemble at full width
    log(f"phase 7p the ODA ensemble (oda/driver.py) on bench.py's CONFIG "
        f"%dx%dx%d fp32, {ODA_MEMBERS} members" % MAIN)
    t0 = time.perf_counter()
    oda_run = run_oda_timed(wrappers)
    torch.cuda.empty_cache()
    log(f"  phase {time.perf_counter() - t0:.1f} s")

    # 8. the solo driver: cases/double_gyre, then bench.py's CONFIG
    with tempfile.TemporaryDirectory() as tmp:
        log("phase 8 driver: cases/double_gyre %dx%dx%d fp64, " % GYRE
            + f"{GYRE_DAYS} days, card vs cpu")
        launches_gyre = run_driver_case(tmp, wrappers)
        log("phase 8 driver: bench.py CONFIG %dx%dx%d fp32, " % MAIN
            + f"{BENCH_STEPS} steps")
        launches_bench = run_driver_bench(tmp, wrappers, shape)
        torch.cuda.empty_cache()
        log("phase 8 driver: cases/tc0 4x4x1 fp64, "
            f"{TC0_DAYS} days, card vs cpu")
        launches_tc0 = run_driver_case(
            tmp, wrappers, "tc0", TC0_DAYS,
            {k: v for k, v in PER_STEP["unsplit"].items()
             if k not in ("K1u", "K1p", "K3o")})
        log(f"phase 8 driver: cases/tc3 10x10x1 fp64 (SSH 0.1 m on a "
            f"segment, three dyes), {TC3_DAYS} days, card vs cpu")
        launches_tc3 = run_driver_case(
            tmp, wrappers, "tc3", TC3_DAYS,
            {"K1": 4, "K2": 0, "K3": 2, "K3m": 0}, edits=TC3_EDITS)
        if barotropic_cuda.subcycle_cuda.obc_launches != launches_tc3["K3"]:
            raise AssertionError("driver tc3: K3 ran its closed instance")
        log("phase 8 driver: cases/ref_tc0 (DEBUG, DIAG_AS_CHKSUM) fp64, "
            "card vs cpu, against its golden")
        launches_ref_tc0 = run_ref_tc0(tmp, wrappers)
        launches_layer = {}
        for case in ("layer_mode", "benchmark"):
            log(f"phase 8 driver: cases/{case} 32x32x8 fp64 (spherical "
                "grid, bowl, WRIGHT_FULL, bulk mixed layer), "
                f"{LAYER_DAYS} days, card vs cpu")
            launches_layer[case] = run_driver_case(
                tmp, wrappers, case, LAYER_DAYS,
                {"K1": 4, "K2": 1, "K3": 2, "K3m": 0}, edits=LAYER_EDITS)
        for case in ("ref_tc1", "ref_tc2"):
            log(f"phase 8 driver: cases/{case} fp64 on the card, against "
                "its golden")
            launches_layer[case] = run_ref_case(tmp, wrappers, case)
        log("phase 8 driver: cases/tc4, cases/ref_tc4 and cases/tc2 fp64 "
            "on the card")
        launches_layer.update(run_file_cases(tmp, wrappers))
        log("phase 8 driver: cases/ref_tc3 (circle_obcs, layer_ref, four "
            "open edges, the DOME dyes) fp64 on the card, against its "
            "golden")
        launches_layer["ref_tc3"] = run_ref_case(
            tmp, wrappers, "ref_tc3",
            per_step={"K1": 4, "K2": 0, "K3": 2, "K3m": 0})
        if barotropic_cuda.subcycle_cuda.obc_launches \
                != launches_layer["ref_tc3"]["K3"]:
            raise AssertionError("driver ref_tc3: K3 ran its closed "
                                 "instance")
        log("phase 8 driver: the offline round trip of "
            "tests/test_offline_driver.py fp64 on the card")
        launches_offline = run_offline_cases(tmp, wrappers)
        log("phase 8 driver: cases/phillips (the Phillips two-layer "
            "channel) fp64 on the card, against the JAX driver's "
            "ocean.stats")
        launches_layer["phillips"] = run_phillips(tmp, wrappers)
        log("phase 8 driver: cases/double_gyre with USE_PARTICLES fp64, "
            f"{GYRE_DAYS} days, card vs cpu (particles.nc)")
        t0 = time.perf_counter()
        launches_layer["particles"] = run_particles_case(tmp, wrappers)
        log(f"  phase {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()

    nk, njh, nih = shape_main
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
        units_traced = PROFILE_REPS * per_call
        n_prof, n_all, dev_ms = traces[k]
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
        if k in modes:
            extra["modes"] = modes[k]
        if k == "K1":
            extra["untargeted_launches_by_path"] = {
                "rk2b_full_step": full["rk2b"]["launches"]["K1u"],
                "unsplit_full_step": full["unsplit"]["launches"]["K1u"]}
        records.append(dict(
            meta, launches=n_launch,
            launches_by_path={
                "slice1_dynamics_step": launches_s1[k],
                "slice2_full_step": launches[k],
                "slice2_full_step_layered": full["layered"]["launches"][k],
                "rk2b_full_step": full["rk2b"]["launches"][k],
                "unsplit_full_step": full["unsplit"]["launches"][k],
                "b1_full_step": full["b1"]["launches"][k],
                "nonbouss_full_step": full["nonbouss"]["launches"][k],
                "obc_full_step": full["obc"]["launches"][k],
                "stoch_full_step": full["stoch"]["launches"][k],
                "b3_full_step": full["b3"]["launches"][k],
                "bml_full_step": full["bml"]["launches"][k],
                "solo_double_gyre": launches_gyre[k],
                "solo_bench_config": launches_bench[k],
                "solo_tc0": launches_tc0[k],
                "solo_tc3": launches_tc3[k],
                "solo_ref_tc0": launches_ref_tc0[k],
                "solo_layer_mode": launches_layer["layer_mode"][k],
                "solo_benchmark": launches_layer["benchmark"][k],
                "b4_full_step": full["b4"]["launches"][k],
                "b4v_full_step": full["b4v"]["launches"][k],
                "hybgen_full_step": full["hybgen"]["launches"][k],
                "adapt_full_step": full["adapt"]["launches"][k],
                "solo_ref_tc1": launches_layer["ref_tc1"][k],
                "solo_ref_tc2": launches_layer["ref_tc2"][k],
                "file_full_step": full["file"]["launches"][k],
                "solo_tc4": launches_layer["tc4"][k],
                "solo_ref_tc4": launches_layer["ref_tc4"][k],
                "solo_tc2": launches_layer["tc2"][k],
                "bgc_full_step": full["bgc"]["launches"][k],
                "solo_ref_tc3": launches_layer["ref_tc3"][k],
                "solo_offline_online_run": launches_offline["box"][k],
                "offline_mode": 0,
                "shelf_full_step": full["shelf"]["launches"][k],
                "shelf_solo_step": shelf_solo["launches"][k],
                "solo_phillips": launches_layer["phillips"][k],
                "hurr_full_step": full["hurr"]["launches"][k],
                "cap_coupling_intervals": cap_run["launches"][k],
                "oda_member_steps": oda_run["launches"][k],
                "solo_double_gyre_particles":
                    launches_layer["particles"][k]},
            max_abs_err=res.err[k]["float32"][1],
            max_rel_err_fp32=res.err[k]["float32"][0],
            max_rel_err_fp64=res.err[k]["float64"][0],
            ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=None, unit=units[k], **extra))
    # the porous instance of K1: its launches on B1's path, its time
    # with the fractions computed beforehand, beside its bound
    por = modes["K1"]["porous"]
    n_por = full["b1"]["launches"]["K1p"]
    log(f"  K1 porous {POROUS_KERNEL['name']}: {por['ms']:.4f} ms per sweep "
        f"(CUDA events), {por['profiled_device_ms']:.4f} ms (profiler), "
        f"{por['with_fractions_ms']:.4f} ms with the plain fractions, "
        f"bound {por['bound_ms']:.4f} ms ({por['bound_by']}), plain "
        f"{por['plain_ms']:.4f} ms, launches {n_por} (B1)")
    records.append(dict(
        POROUS_KERNEL, launches=n_por,
        launches_by_path={"b1_full_step": n_por},
        max_abs_err=max(res.modes[("K1", m)] for m in POROUS_MODES),
        ms=por["ms"], plain_ms=por["plain_ms"], bound_ms=por["bound_ms"],
        bound_by=por["bound_by"], library_ms=None, unit="per sweep",
        profiled_device_ms=por["profiled_device_ms"],
        with_fractions_ms=por["with_fractions_ms"],
        untargeted=modes["K1"]["porous_untargeted"]))
    # K3's open-face instance: its launches on the OBC path, its time at
    # the main path's shape beside its bound and the plain version's
    ms, plain_ms, (inp, edges) = timing["K3o"]
    elems, ops = subcycle_work(inp)
    n_faces = sum(e[0].numel() for e in edges if e is not None)
    b_ms, b_by = bound(elems + 4 * n_faces, ops + 2 * OPS_FLATHER
                       * n_faces * inp.wts.shape[1], 4, "float32")
    n_obc = full["obc"]["launches"]["K3o"]
    n_prof, n_all, dev_ms = traces["K3o"]
    log(f"  K3o {OBC_KERNEL['name']}: {ms:.4f} ms per subcycle (CUDA "
        f"events), {dev_ms:.4f} ms (profiler), bound {b_ms:.4f} ms "
        f"({b_by}), plain {plain_ms:.4f} ms, launches {n_obc} "
        f"({bc_plan(inp)}, {inp.wts.shape[1]} substeps)")
    records.append(dict(
        OBC_KERNEL, launches=n_obc,
        launches_by_path={"obc_full_step": n_obc,
                          "solo_tc3": launches_tc3["K3"],
                          "solo_ref_tc3": launches_layer["ref_tc3"]["K3"]},
        max_abs_err=res.err["K3o"]["float32"][1],
        max_rel_err_fp32=res.err["K3o"]["float32"][0],
        max_rel_err_fp64=res.err["K3o"]["float64"][0],
        ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=None, unit="per subcycle", profiled_device_ms=dev_ms,
        profiled_kernels_per_call=n_prof / PROFILE_REPS,
        ptxas=subcycle_ptxas))
    for dyn in ("b1", "nonbouss", "obc", "stoch", "b3", "bml", "b4", "b4v",
                "hybgen", "adapt", "file", "bgc", "shelf", "hurr"):
        r = full[dyn]
        log(f"  {dyn}: {r['ms_step']:.3f} ms/step, "
            + ", ".join(f"{k} {v:.3f}" for k, v in r["by_kind"].items())
            + f", peak {r['peak_bytes'] / 2**30:.3f} GiB, launches "
            f"{r['launches']}")
    log(f"  cap: {cap_run['ms_interval']:.3f} ms a coupling interval of "
        f"{CAP_STEPS} steps, peak {cap_run['peak_bytes'] / 2**30:.3f} GiB, "
        f"launches {cap_run['launches']}")
    log(f"  ODA: {oda_run['ms_member_step']:.3f} ms a member step, peak "
        f"{oda_run['peak_bytes'] / 2**30:.3f} GiB, launches "
        f"{oda_run['launches']}")
    log(f"  shelf-only: {shelf_solo['ms_step']:.3f} ms a step, "
        f"{shelf_solo['kernels']} kernels a step, idle share "
        f"{shelf_solo['idle_share']:.1%}")
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
    print(smi, flush=True)
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
