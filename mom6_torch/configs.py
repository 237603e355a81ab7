"""Configurations the port ships as text.

``BENCH_CONFIG`` is the port's own copy of bench.py's ``CONFIG``, the
benchmark configuration: a 512x512x25 reentrant channel with Z* ALE,
KPP, GM, MLE, PLM T/S and ideal-age transport, gyre wind and linear
SST restoring.  ``entry.build_full`` builds it through
``model.build_model``; a test holds the text equal to bench.py's.

``BENCH_CONFIG_RK2B`` is the same configuration on the split RK2b
dynamics, and ``BENCH_CONFIG_UNSPLIT`` on the unsplit RK3 dynamics: with
no barotropic subcycle the step resolves the external gravity wave,
c = sqrt(9.81 * 4000) ~ 198 m/s on 10 km cells, a Courant number of
0.40 per direction at DT = 20 s (DT_THERM = 120 s keeps six dynamics
steps a thermodynamic step, against two in the split configuration).
``BENCH_CONFIG_B1`` turns on the Boussinesq dynamics options of the
first breadth item on bench.py's grid, laid out in degrees (0.1 degree
cells from 25.6 S to 25.6 N, so the tidal potential sees real
latitudes): M2 and K1 equilibrium tides with spherical-harmonic SAL to
degree 6, the Stanley pressure-force correction, porous barriers read
from ``topog_edge.nc`` in INPUTDIR (``write_topog_edge`` makes one from
a seed), ZB2020 and modified-Leith biharmonic viscosity beside the
Smagorinsky one, the bounded and strong-drag barotropic options with
BEGW, and the BBL, HARMONIC_VISC and KV_ML_INVZ2 vertical-friction
options.  ``BENCH_CONFIG_NONBOUSS`` runs bench.py's configuration
non-Boussinesq (h carries mass) with channel and linear drag, the wind
stress as a body force, the dynamic viscous mixed layer and a
velocity-scale floor on the biharmonic viscosity.

``BENCH_CONFIG_OBC`` is a regional, adiabatic configuration on bench.py's
grid: walls only in y, 25 uniform layers at rest with no thermodynamics
and no GM thickness diffusion (whose halo refresh would clear the
thickness beyond the open edges, so that inflow carried no tracer),
bench.py's gyre wind, viscosities and DT, and three open segments with
Flather barotropic and Orlanski baroclinic radiation: the whole W edge
with a 0.05 m/s inflow, the whole E edge nudged to the profiles of
``obc_east.nc`` in INPUTDIR (two records a day apart, interpolated in
time; ``write_obc_data`` writes one from a seed), and a strip over the
middle half of the S edge (``obc_strip`` gives its line at other
widths); one dye per segment (NUM_DYE_TRACERS), and the free-slip
vorticity and strain and no biharmonic stress at the open faces.

``BENCH_CONFIG_STOCH`` is bench.py's configuration with the rest of the
first breadth item on: the GM thickness diffusion and the column
physics with ALE before the dynamics (THICKNESSDIFFUSE_FIRST,
DIABATIC_FIRST), the GME backscatter stress, the Stanley pressure-force
correction with its stochastic multiplier (STOCH_EOS), and the SPPT
tendency perturbations and SKEB backscatter, all with their defaults.

``BENCH_CONFIG_B3`` is bench.py's configuration (Z* ALE) with the column
physics of the third breadth item in place of KPP: the ePBL boundary
layer with the Langmuir enhancement of USE_WAVES, Jackson-Hallberg-Legg
kappa-shear (whose shear viscosity the next dynamics step adds to KV),
CVMix convection, double diffusion, tidal mixing from a uniform energy
flux, the law-of-the-wall bottom boundary layer, mixed-layer radiation,
full convection, frazil and a 0.05 W m-2 geothermal flux; PEN_SW_NBANDS
= 3 is read and inert, since the linear restoring sets no shortwave.
``BENCH_CONFIG_BML`` is bench.py's layered variant (USE_REGRIDDING =
False) with the layered column physics: the bulk mixed layer in place of
KPP, LMD94 shear mixing, diffusive entrainment (on by its layered
default), the regularization of the surface layers and frazil.

``BENCH_CONFIG_B4`` is bench.py's configuration (Z* ALE, KPP) with the
fourth breadth item as ``cases/ref_tc2`` runs it: MEKE, VarMix, neutral
and boundary diffusion, the interface filter and the internal tides.
``BENCH_CONFIG_B4V`` is ``BENCH_CONFIG_BML`` (layered) with the item as
``cases/ref_tc1`` runs it: the Visbeck diffusivities, the resolution
scaling of KH, KHTH and KHTR, the mixed layer's epipycnal diffusion and
GM before the dynamics.  Neutral diffusion and the along-layer KHTR
path exclude each other, hence two texts.

``BENCH_CONFIG_HYBGEN`` is bench.py's configuration on the HYCOM hybrid
coordinate that regional and coastal users run: the TEOS-10 equation of
state, target densities from a 16 to 4 degC ladder at P_REF
(COORD_CONFIG ts_range), the hybgen generator with the PPM_HYBGEN remap
for tracers and WENO_HYBGEN for velocities, and the initial grid
regridded three times before the first step (REGRID_ACCELERATE_INIT).
``BENCH_CONFIG_ADAPT`` is bench.py's configuration on the ADAPTIVE
coordinate with the ROQUET_RHO polynomial and the PLM_HYBGEN remap.
``BENCH_CONFIG_UNMIX`` is bench.py's configuration on HYCOM1 with hybgen
unmixing, the ROQUET_SPV polynomial and the same density ladder.  Each
text's lines are commented where they are defined.

``BENCH_CONFIG_FILE`` is bench.py's configuration set up and forced from
files, the way regional and global runs are: the bottom from a
topography file (the flat 4000 m with a land peninsula from the southern
wall), T and S from a coarser lon/lat/depth file on 33 WOA-like levels
(filled under land, regridded bilinearly, remapped onto the z* layers),
an ALE sponge over N and S strips restoring toward targets on those 33
levels, a monthly wind and monthly shortwave, longwave, latent,
sensible, evaporation and rain files, and a ``data_table`` with one
constant and one off-grid (bilinear) override.  ``write_file_inputs``
writes the files from a seed; TS_CONFIG and T_RANGE stay in the text
unread.

``BENCH_CONFIG_BGC`` is bench.py's configuration with biogeochemistry on,
as a regional or global MOM6-MARBL run has it: the MARBL-shaped coupler
with its base-bio package (no3, po4, sio3, fe, dic, alk, o2, doc and a
sinking poc), the CFC pair riding its gas exchange and a pseudo-salt
tracer, 13 passive tracers beside T and S and the ideal age.  Every
channel is fed from files (``write_bgc_inputs``): no3, po4 and sio3
restored toward nutricline-shaped climatologies on the 33 WOA levels
with a 30-day timescale over the N and S strips, monthly river sources
along the two walls, monthly dust and nitrogen deposition and a static
sediment iron flux.

``BENCH_CONFIG_SHELF`` is bench.py's configuration under an ice shelf,
the cavity that ice-ocean users run: a channel profile 500 m thick at
the west wall thinning to nothing over the default SHELF_LENGTH_LON (a
quarter of LENLON), its pressure on the surface (the columns depressed
into isostatic balance at the start, the top layers ~443 m down),
the wind shielded under it, and the three-equation melt of the top
layer every thermodynamic step, over the ISOMIP+ Ocean0 (warm) profile
of TS_CONFIG ISOMIP, -1.9 degC and 33.8 at the surface to 1.0 degC and
34.7 at the bottom (Asay-Davis et al. 2016, GMD 9, 2471).  The
channel is closed in x, as ISOMIP's is: across a reentrant seam the
shelf would end in a 500 m ice cliff, whose pressure the depressed
surface balances only to (1 - rho/RHO_0), ~35 kPa over one cell, and
the JAX package too reaches the velocity truncation in one step there
(``tools/shelf_text_bounded.py --extra "#override REENTRANT_X = True"``).
The bottom stays flat; T_RANGE stays in the text unread.

``BENCH_CONFIG_HURR`` is bench.py's configuration under an idealized
translating tropical cyclone, the case ocean modellers use to study the
upper ocean's response to a storm (cooling, near-inertial currents, the
cold wake): WIND_CONFIG ideal_hurr in place of the gyre wind, a storm of
the default Holland profile (96,800 Pa at its centre against 101,200,
65 m/s at 50 km) heading west at 5 m/s from three quarters of the way
east and mid-basin (IDL_HURR_X0 = 3.84e6 m and IDL_HURR_Y0 = 2.56e6 m on
the 5,120 km basin; the grid's km times the reference's 1000; at its
default origin the storm would start at the south-west corner and leave
the basin at once), and BUOY_CONFIG const_heat with a uniform surface
heat loss of 100 W m-2 in place of the restoring.  ``entry.build_full``
moves the storm's origin with the basin at other widths.  At 16x16x4
(the storm's origin moved with the basin) the JAX package keeps it
bounded over 12 steps (``tools/hurr_text_bounded.py``).

A test holds each to ``BENCH_CONFIG`` plus exactly its lines.
"""

import numpy as np

__all__ = ["BENCH_CONFIG", "BENCH_CONFIG_RK2B", "BENCH_CONFIG_UNSPLIT",
           "BENCH_CONFIG_B1", "BENCH_CONFIG_NONBOUSS", "BENCH_CONFIG_OBC",
           "BENCH_CONFIG_STOCH", "BENCH_CONFIG_B3", "BENCH_CONFIG_BML",
           "BENCH_CONFIG_B4", "BENCH_CONFIG_B4V", "BENCH_CONFIG_HYBGEN",
           "BENCH_CONFIG_ADAPT", "BENCH_CONFIG_UNMIX",
           "B1_LINES", "NONBOUSS_LINES", "OBC_LINES", "STOCH_LINES",
           "B3_LINES", "BML_LINES", "B4_LINES", "B4V_LINES",
           "HYBGEN_LINES", "ADAPT_LINES", "UNMIX_LINES", "BENCH_CONFIG_FILE",
           "FILE_LINES", "FILE_DATA_TABLE", "WOA_DEPTHS", "file_fields",
           "write_file_inputs", "BENCH_CONFIG_BGC", "BGC_LINES",
           "BGC_RIVERS", "bgc_fields", "write_bgc_inputs", "obc_strip",
           "obc_east_fields", "topog_edge_fields", "write_obc_data",
           "write_topog_edge", "BENCH_CONFIG_SHELF", "SHELF_LINES",
           "BENCH_CONFIG_HURR", "HURR_LINES"]

BENCH_CONFIG = """
NIGLOBAL = 512
NJGLOBAL = 512
NK = 25
DT = 600.0
DT_THERM = 1200.0
DAYMAX = 1.0
GRID_CONFIG = cartesian
AXIS_UNITS = k
LENLON = 5120.0
LENLAT = 5120.0
REENTRANT_X = True
TOPO_CONFIG = flat
MAXIMUM_DEPTH = 4000.0
F_0 = 1.0e-4
BETA = 2.0e-11
TS_CONFIG = linear
T_RANGE = 12.0
EQN_OF_STATE = WRIGHT
BULKMIXEDLAYER = False
USE_REGRIDDING = True
REGRIDDING_COORDINATE_MODE = Z*
KD = 1.0e-5
USE_KPP = True
KHTH = 600.0
KHTR = 600.0
MIXEDLAYER_RESTRAT = True
WIND_CONFIG = gyres
TAUX_MAGNITUDE = 0.1
BUOY_CONFIG = linear_restoring
RESTOREBUOY = True
FLUXCONST = 0.5
USE_IDEAL_AGE_TRACER = True
BIHARMONIC = True
SMAGORINSKY_AH = True
SMAG_BI_CONST = 0.06
"""

BENCH_CONFIG_RK2B = BENCH_CONFIG + "SPLIT_RK2B = True\n"

BENCH_CONFIG_UNSPLIT = (BENCH_CONFIG + "SPLIT = False\n"
                        "#override DT = 20.0\n"
                        "#override DT_THERM = 120.0\n")

B1_LINES = """#override AXIS_UNITS = degrees
#override LENLON = 51.2
#override LENLAT = 51.2
SOUTHLAT = -25.6
TIDES = True
TIDE_M2 = True
TIDE_K1 = True
SAL_HARMONICS = True
SAL_HARMONICS_DEGREE = 6
USE_STANLEY_PGF = True
STANLEY_COEFF = 0.5
SUBGRID_TOPO_AT_VEL = True
TOPO_AT_VEL_FILE = topog_edge.nc
USE_ZB2020 = True
LEITH_AH = True
LEITH_BI_CONST = 1.0
MODIFIED_LEITH = True
BOUND_BT_CORRECTION = True
MAXCFL_BT_CONT = 0.1
BT_STRONG_DRAG = True
BEGW = 0.1
BBL_USE_EOS = True
HARMONIC_VISC = True
KV_ML_INVZ2 = 0.01
"""

NONBOUSS_LINES = """BOUSSINESQ = False
CHANNEL_DRAG = True
DIRECT_STRESS = True
HMIX_STRESS = 50.0
DYNAMIC_VISCOUS_ML = True
LINEAR_DRAG = True
DRAG_BG_VEL = 0.05
BT_PROJECT_VELOCITY = True
AH_VEL_SCALE = 0.01
"""

OBC_LINES = """#override REENTRANT_X = False
#override USE_REGRIDDING = False
#override KHTH = 0.0
ENABLE_THERMODYNAMICS = False
ADIABATIC = True
OBC_NUMBER_OF_SEGMENTS = 3
OBC_SEGMENT_001 = "I=0,J=0:N,FLATHER,ORLANSKI"
OBC_SEGMENT_001_DATA = "U=value:0.05,V=value:0.0,SSH=value:0.0"
OBC_SEGMENT_002 = "I=N,J=0:N,FLATHER,ORLANSKI,NUDGED"
OBC_SEGMENT_002_DATA = "U=file:obc_east.nc(u),SSH=file:obc_east.nc(ssh)"
OBC_SEGMENT_002_VELOCITY_NUDGING_TIMESCALES = 0.3, 3.0
OBC_SEGMENT_003 = "J=0,I=128:384,FLATHER,ORLANSKI"
NUM_DYE_TRACERS = 3
OBC_FREESLIP_VORTICITY = True
OBC_FREESLIP_STRAIN = True
OBC_ZERO_BIHARMONIC = True
"""

STOCH_LINES = """THICKNESSDIFFUSE_FIRST = True
DIABATIC_FIRST = True
USE_GME = True
USE_STANLEY_PGF = True
STANLEY_COEFF = 0.5
STOCH_EOS = True
DO_SPPT = True
DO_SKEB = True
"""

B3_LINES = """#override USE_KPP = False
ENERGETICS_SFC_PBL = True
USE_JACKSON_PARAM = True
USE_CVMIX_CONVECTION = True
DOUBLE_DIFFUSION = True
INT_TIDE_DISSIPATION = True
USE_LOTW_BBL_DIFFUSIVITY = True
ML_RADIATION = True
FULL_CONVECTION = True
FRAZIL = True
USE_WAVES = True
GEOTHERMAL_FLUX = 0.05
PEN_SW_NBANDS = 3
"""

BML_LINES = """#override USE_REGRIDDING = False
#override BULKMIXEDLAYER = True
#override USE_KPP = False
REGULARIZE_SURFACE_LAYERS = True
USE_LMD94 = True
FRAZIL = True
"""

# the fourth breadth item on the Z* text, what cases/ref_tc2 runs: MEKE
# with ref_tc2's coefficients (the GM source, KHTH/KHTR shares, its own
# diffusion, the Ku viscosity, Rhines and Eady mixing lengths; Ku needs
# the Laplacian operator, with KH = 0 Ku is all of it), VarMix with the
# EOS slopes, neutral diffusion in place of the along-layer KHTR, the
# boundary diffusion inside KPP's boundary layer, the interface filter,
# and the internal tides (24 angles) feeding the tidal mixing
B4_LINES = """USE_MEKE = True
MEKE_GMCOEFF = 1.0
MEKE_BGSRC = 1.0E-13
MEKE_KHTH_FAC = 0.5
MEKE_KHTR_FAC = 0.5
MEKE_KHMEKE_FAC = 1.0
MEKE_VISCOSITY_COEFF_KU = 1.0
MEKE_ALPHA_RHINES = 0.15
MEKE_ALPHA_EADY = 0.15
LAPLACIAN = True
USE_VARIABLE_MIXING = True
USE_STORED_SLOPES = True
USE_NEUTRAL_DIFFUSION = True
USE_HORIZONTAL_BOUNDARY_DIFFUSION = True
INTERFACE_FILTER_TIME_SCALE = 86400.0
INTERNAL_TIDES = True
INTERNAL_TIDE_ANGLES = 24
UTIDE = 0.02
INT_TIDE_DISSIPATION = True
"""

# the fourth breadth item on the layered text, what cases/ref_tc1 runs:
# the Visbeck diffusivity (ref_tc1's length scale and VARMIX_KTOP) into
# KHTH and KHTR, the resolution function on KH, KHTH and KHTR (averaged
# to the faces, Pedlosky's deformation radius), the mixed layer's
# epipycnal diffusion into the interior, and GM before the dynamics
B4V_LINES = """USE_VARIABLE_MIXING = True
USE_VISBECK = True
RESOLN_SCALED_KH = True
RESOLN_SCALED_KHTH = True
RESOLN_SCALED_KHTR = True
KHTH_SLOPE_CFF = 0.1
KHTR_SLOPE_CFF = 0.1
VARMIX_KTOP = 6
VISBECK_L_SCALE = 3.0E+04
INTERPOLATE_RES_FN = True
GILL_EQUATORIAL_LD = False
DIFFUSE_ML_TO_INTERIOR = True
THICKNESSDIFFUSE_FIRST = True
"""

# the fifth and sixth breadth items: a TEOS-10 ocean on the hybgen
# hybrid coordinate, its layer targets the densities at P_REF of a T
# ladder from 16 degC (light) to 4 degC (dense) at S_REF, the hybgen
# remap schemes (PPM for tracers, WENO for velocities), and the initial
# z* grid regridded three times toward its attractor before the first
# step
HYBGEN_LINES = """#override EQN_OF_STATE = TEOS10
COORD_CONFIG = ts_range
TS_RANGE_T_LIGHT = 16.0
TS_RANGE_T_DENSE = 4.0
#override REGRIDDING_COORDINATE_MODE = HYBGEN
REMAPPING_SCHEME = PPM_HYBGEN
VELOCITY_REMAPPING_SCHEME = WENO_HYBGEN
REGRID_ACCELERATE_INIT = True
REGRID_ACCELERATE_ITERATIONS = 3
"""

# the ADAPTIVE coordinate (interfaces chase the lateral curvature of
# neutral density under a vertical grid diffusion) with the 55-term
# Roquet density polynomial and the PLM_HYBGEN remap for every field
ADAPT_LINES = """#override EQN_OF_STATE = ROQUET_RHO
#override REGRIDDING_COORDINATE_MODE = ADAPTIVE
REMAPPING_SCHEME = PLM_HYBGEN
"""

# HYCOM1 (isopycnal interfaces held below the nominal z* depths) on the
# same density ladder, with the deepest inflated layer unmixed toward
# its target before each regrid, and the Roquet specific-volume fit.  S
# rises by 1 ppt down the column: under a uniform S the unmixing's
# T/S split divides S differences of roundoff size by each other, and
# its result follows the last bits of the state
UNMIX_LINES = """#override EQN_OF_STATE = ROQUET_SPV
S_RANGE = 1.0
COORD_CONFIG = ts_range
TS_RANGE_T_LIGHT = 16.0
TS_RANGE_T_DENSE = 4.0
#override REGRIDDING_COORDINATE_MODE = HYCOM1
HYBGEN_UNMIX = True
"""

BENCH_CONFIG_B1 = BENCH_CONFIG + B1_LINES

BENCH_CONFIG_NONBOUSS = BENCH_CONFIG + NONBOUSS_LINES

BENCH_CONFIG_OBC = BENCH_CONFIG + OBC_LINES

BENCH_CONFIG_STOCH = BENCH_CONFIG + STOCH_LINES

BENCH_CONFIG_B3 = BENCH_CONFIG + B3_LINES

BENCH_CONFIG_BML = BENCH_CONFIG + BML_LINES

BENCH_CONFIG_B4 = BENCH_CONFIG + B4_LINES

BENCH_CONFIG_B4V = BENCH_CONFIG_BML + B4V_LINES

BENCH_CONFIG_HYBGEN = BENCH_CONFIG + HYBGEN_LINES

BENCH_CONFIG_ADAPT = BENCH_CONFIG + ADAPT_LINES

BENCH_CONFIG_UNMIX = BENCH_CONFIG + UNMIX_LINES

# the set-up and forcing from files; the files are those of
# write_file_inputs, in INPUTDIR
FILE_LINES = """#override TOPO_CONFIG = file
TOPO_FILE = topog.nc
INIT_LAYERS_FROM_Z_FILE = True
TEMP_SALT_Z_INIT_FILE = ts_z.nc
Z_INIT_ALE_REMAPPING = True
SPONGE = True
SPONGE_DAMPING_FILE = sponge.nc
SPONGE_STATE_FILE = sponge_ts.nc
SPONGE_PTEMP_VAR = ptemp
SPONGE_SALT_VAR = salt
#override WIND_CONFIG = file
WIND_FILE = wind.nc
WINDSTRESS_X_VAR = taux
WINDSTRESS_Y_VAR = tauy
#override BUOY_CONFIG = file
SHORTWAVE_FILE = buoy.nc
LONGWAVE_FILE = buoy.nc
LATENTHEAT_FILE = buoy.nc
SENSIBLEHEAT_FILE = buoy.nc
EVAPORATION_FILE = buoy.nc
RAIN_FILE = buoy.nc
"""

BENCH_CONFIG_FILE = BENCH_CONFIG + FILE_LINES

# a constant sensible heat flux, and the meridional stress from an
# off-grid monthly file regridded bilinearly to the v points
FILE_DATA_TABLE = """# gridname, field, file variable, file, ongrid, factor
"OCN", "sensible", "", "", .false., -12.0
"OCN", "tauy", "tauy", "override.nc", .false., 1.0
"""

# the 33 standard depths of the World Ocean Atlas [m]
WOA_DEPTHS = (0.0, 10.0, 20.0, 30.0, 50.0, 75.0, 100.0, 125.0, 150.0,
              200.0, 250.0, 300.0, 400.0, 500.0, 600.0, 700.0, 800.0,
              900.0, 1000.0, 1100.0, 1200.0, 1300.0, 1400.0, 1500.0,
              1750.0, 2000.0, 2500.0, 3000.0, 3500.0, 4000.0, 4500.0,
              5000.0, 5500.0)
_MISSING = -1.0e20


def _profiles(z, y):
    """WOA-like T and S at depths ``z`` [m] and fractional latitude
    ``y`` in [0, 1]: a 700 m thermocline warmer to the south, a fresher
    surface to the north."""
    T = 2.0 + (14.0 + 8.0 * (0.5 - y)) * np.exp(-z / 700.0)
    S = 34.7 + (0.5 - 0.6 * (y - 0.5)) * np.exp(-z / 500.0)
    return T, S


def file_fields(ni: int, nj: int, seed: int, dx_km: float = 10.0) -> dict:
    """The inputs of ``BENCH_CONFIG_FILE`` on an ``ni`` x ``nj`` grid of
    ``dx_km`` cells, as {file name: {variable: array}} (each with its
    ``dims`` and ``attrs`` under the keys of the same name):

    * topog.nc: 4000 m, with land (0 m) over the middle tenth in x from
      the southern wall to 0.6 of the way north;
    * ts_z.nc: ptemp and salt (33 levels, ``WOA_DEPTHS``) on a
      min(128, max(8, ni // 4))-point square lon/lat grid over the
      domain, missing (-1e20) under the peninsula, with seeded noise of
      0.05 degC and 0.005 ppt;
    * sponge.nc: Idamp, 1/day at the N and S walls falling linearly to 0
      over strips of min(32, max(2, nj // 8)) rows; sponge_ts.nc: the
      noise-free profiles on the model's points and the 33 levels;
    * wind.nc: 12 monthly records (mid-month, 360-day modulo axis) of
      taux (gyres, 0.1 Pa, with a 30 % seasonal swing) and tauy;
    * buoy.nc: 12 monthly records of SW, LW, latent, sensible, evap and
      liq_precip on the grid, near a zero net budget;
    * override.nc: 12 monthly records of tauy on the coarse lon/lat
      grid."""
    rng = np.random.default_rng(seed)
    lenlon, lenlat = ni * dx_km, nj * dx_km
    yc = (np.arange(nj) + 0.5) / nj
    xc = (np.arange(ni) + 0.5) / ni
    Y, X = np.meshgrid(yc, xc, indexing="ij")
    land = (X >= 0.45) & (X < 0.55) & (Y < 0.6)
    depth = np.where(land, 0.0, 4000.0)

    ns = min(128, max(8, ni // 4))
    ys = (np.arange(ns) + 0.5) / ns
    Ys, Xs = np.meshgrid(ys, ys, indexing="ij")
    z = np.asarray(WOA_DEPTHS)[:, None, None]
    T, S = _profiles(z, Ys[None])
    T = T + 0.05 * rng.standard_normal(T.shape)
    S = S + 0.005 * rng.standard_normal(S.shape)
    land_s = ((Xs >= 0.45) & (Xs < 0.55) & (Ys < 0.6))[None]
    T = np.where(land_s, _MISSING, T)
    S = np.where(land_s, _MISSING, S)

    strip = min(32, max(2, nj // 8))
    j = np.arange(nj)[:, None] + np.zeros((1, ni))
    dist = np.minimum(j, nj - 1 - j)
    idamp = np.clip(1.0 - dist / strip, 0.0, 1.0) / 86400.0
    T_sp, S_sp = _profiles(z, Y[None])

    month = (np.arange(12) + 0.5) / 12.0
    season = np.sin(2.0 * np.pi * month)[:, None, None]
    taux = 0.1 * -np.cos(2.0 * np.pi * Y)[None] * (1.0 + 0.3 * season)
    tauy = 0.02 * np.sin(2.0 * np.pi * X)[None] * np.cos(
        2.0 * np.pi * month)[:, None, None]
    sw = 180.0 + 60.0 * season * (1.0 - Y[None])
    lw = np.full_like(sw, -60.0)
    latent = np.broadcast_to(-95.0 + 10.0 * season, sw.shape)
    sensible = np.full_like(sw, -12.0)
    evap = np.broadcast_to(3.5e-5 + 0.5e-5 * season, sw.shape)
    lprec = np.full_like(sw, 3.4e-5)
    tauy_s = 0.03 * np.sin(2.0 * np.pi * Xs)[None] * np.cos(
        2.0 * np.pi * month)[:, None, None]

    f32 = np.float32
    time_ax = {"time": (30.0 * np.arange(12) + 15.0)}
    t_attrs = {"time": {"units": "days since 0001-01-01",
                        "modulo": "360"}}
    lonlat = {"lon": (np.arange(ns) + 0.5) * lenlon / ns,
              "lat": (np.arange(ns) + 0.5) * lenlat / ns}
    zyx = ("depth", "lat", "lon")
    tyx = ("time", "ny", "nx")
    return {
        "topog.nc": {"depth": depth},
        "ts_z.nc": dict(lonlat, depth=np.asarray(WOA_DEPTHS),
                        ptemp=T.astype(f32), salt=S.astype(f32),
                        dims={"lon": ("lon",), "lat": ("lat",),
                              "depth": ("depth",), "ptemp": zyx,
                              "salt": zyx}),
        "sponge.nc": {"Idamp": idamp},
        "sponge_ts.nc": {"depth": np.asarray(WOA_DEPTHS),
                         "ptemp": T_sp.astype(f32), "salt": S_sp.astype(f32),
                         "dims": {"depth": ("depth",),
                                  "ptemp": ("depth", "ny", "nx"),
                                  "salt": ("depth", "ny", "nx")}},
        "wind.nc": dict(time_ax, taux=taux.astype(f32),
                        tauy=tauy.astype(f32),
                        dims={"time": ("time",), "taux": tyx, "tauy": tyx},
                        attrs=t_attrs),
        "buoy.nc": dict(time_ax, SW=sw.astype(f32), LW=lw.astype(f32),
                        latent=latent.astype(f32),
                        sensible=sensible.astype(f32),
                        evap=evap.astype(f32), liq_precip=lprec.astype(f32),
                        dims=dict({"time": ("time",)}, **{
                            k: tyx for k in ("SW", "LW", "latent",
                                             "sensible", "evap",
                                             "liq_precip")}),
                        attrs=t_attrs),
        "override.nc": dict(time_ax, **lonlat, tauy=tauy_s.astype(f32),
                            dims={"time": ("time",), "lon": ("lon",),
                                  "lat": ("lat",),
                                  "tauy": ("time", "lat", "lon")},
                            attrs=t_attrs)}


def write_file_inputs(indir: str, ni: int, nj: int, seed: int = 0) -> None:
    """The files of ``file_fields`` and the ``data_table`` of
    ``FILE_DATA_TABLE`` in ``indir``."""
    import os
    from mom6_torch.framework.io import write_fields
    for name, fields in file_fields(ni, nj, seed).items():
        fields = dict(fields)
        dims, attrs = fields.pop("dims", None), fields.pop("attrs", None)
        write_fields(os.path.join(indir, name), fields, dims=dims,
                     attrs=attrs)
    with open(os.path.join(indir, "data_table"), "w") as fh:
        fh.write(FILE_DATA_TABLE)


# biogeochemistry with every coupling channel fed from the files of
# write_bgc_inputs, in INPUTDIR
BGC_LINES = """USE_PSEUDO_SALT_TRACER = True
USE_MARBL_TRACERS = True
USE_OCMIP2_CFC = True
MARBL_TRACER_RESTORING_SOURCE = file
MARBL_TRACER_RESTORING_FILE = bgc_restoring.nc
READ_RIV_FLUXES = True
RIV_FLUX_FILE = bgc_riv.nc
MARBL_DUST_FLUX_FILE = bgc_dust.nc
MARBL_NDEP_FILE = bgc_ndep.nc
MARBL_FESEDFLUX_FILE = bgc_fesed.nc
"""

BENCH_CONFIG_BGC = BENCH_CONFIG + BGC_LINES

# an ice shelf over bench.py's configuration, with the ISOMIP+ Ocean0
# profile
SHELF_LINES = """#override REENTRANT_X = False
ICE_SHELF = True
ICE_PROFILE_CONFIG = channel
SHELF_MAX_THICKNESS = 500.0
#override TS_CONFIG = ISOMIP
ISOMIP_T_SUR = -1.9
ISOMIP_S_SUR = 33.8
ISOMIP_T_BOT = 1.0
ISOMIP_S_BOT = 34.7
"""

BENCH_CONFIG_SHELF = BENCH_CONFIG + SHELF_LINES

# the tropical cyclone: ideal_hurr in place of the gyre wind, a constant
# surface heat loss in place of the restoring
HURR_LINES = """#override WIND_CONFIG = ideal_hurr
IDL_HURR_X0 = 3.84e6
IDL_HURR_Y0 = 2.56e6
#override BUOY_CONFIG = const_heat
SENSIBLE_HEAT_FLUX = -100.0
"""
BENCH_CONFIG_HURR = BENCH_CONFIG + HURR_LINES

# the tracers of the river file, and each one's source strength at a
# river mouth [mmol m-2 s-1]
BGC_RIVERS = {"no3": 2.0e-4, "po4": 1.2e-5, "sio3": 3.0e-4, "fe": 1.0e-7,
              "dic": 1.5e-2, "alk": 1.5e-2, "doc": 1.0e-3}


def bgc_fields(ni: int, nj: int, seed: int) -> dict:
    """The inputs of ``BENCH_CONFIG_BGC`` on the ``ni`` x ``nj`` compute
    domain, as {file name: {variable: array}} (each with its ``dims``
    and ``attrs`` under the keys of the same name); every field float64:

    * bgc_restoring.nc: ``z_edges`` (34, about the 33 ``WOA_DEPTHS``),
      no3, po4 and sio3 nutriclines (30, 2.2 and 110 mmol m-3 at depth
      over e-folding depths of 400, 400 and 1000 m, with seeded noise of
      2 % of their deep values, kept >= 0) and I_TAU, 1/(30 days) over
      the N and S strips of min(32, max(2, nj // 8)) rows and 0
      elsewhere;
    * bgc_riv.nc: 12 monthly records of <tracer>_riv_flux for the
      tracers of ``BGC_RIVERS``, 0 but at max(2, ni // 32) river mouths
      along each of the two walls (the first and last rows), with a
      seasonal swing of 50 % and seeded strengths of 0.5-1.5 times the
      nominal;
    * bgc_dust.nc: 12 monthly records of ``dust`` [kg m-2 s-1], 1e-10
      falling northward with a seasonal swing, and bgc_ndep.nc of
      ``ndep`` [mmol m-2 s-1], 1e-6 with seeded noise;
    * bgc_fesed.nc: a static ``FESEDFLUX`` [mmol m-2 s-1], 1e-7 with
      seeded noise."""
    rng = np.random.default_rng(seed)
    z = np.asarray(WOA_DEPTHS)
    z_edges = np.concatenate([[0.0], 0.5 * (z[1:] + z[:-1]),
                              [z[-1] + 0.5 * (z[-1] - z[-2])]])
    zc = z[:, None, None]
    shape3 = (len(z), nj, ni)
    clim = {}
    for name, deep, scale in (("no3", 30.0, 400.0), ("po4", 2.2, 400.0),
                              ("sio3", 110.0, 1000.0)):
        prof = deep * (1.0 - np.exp(-(zc + 5.0) / scale))
        clim[name] = np.maximum(
            prof + 0.02 * deep * rng.standard_normal(shape3), 0.0)
    strip = min(32, max(2, nj // 8))
    j = np.arange(nj)[:, None] + np.zeros((1, ni))
    in_strip = np.minimum(j, nj - 1 - j) < strip
    i_tau = np.broadcast_to(np.where(in_strip, 1.0 / (30.0 * 86400.0), 0.0),
                            shape3).copy()

    month = (np.arange(12) + 0.5) / 12.0
    season = np.sin(2.0 * np.pi * month)[:, None, None]
    nsrc = max(2, ni // 32)
    mouths = ((np.arange(nsrc) + 0.5) * ni / nsrc).astype(int)
    rivers = {}
    for name, q in BGC_RIVERS.items():
        f = np.zeros((12, nj, ni))
        for row in (0, nj - 1):
            f[:, row, mouths] = q * rng.uniform(0.5, 1.5, nsrc)
        rivers[f"{name}_riv_flux"] = f * (1.0 + 0.5 * season)
    yc = (np.arange(nj) + 0.5) / nj
    dust = 1e-10 * np.exp(-2.0 * yc)[None, :, None] \
        * (1.0 + 0.4 * season) * np.ones((12, nj, ni))
    ndep = 1e-6 * (1.0 + 0.1 * rng.standard_normal((12, nj, ni)))
    fesed = 1e-7 * (1.0 + 0.2 * rng.standard_normal((nj, ni)))

    time_ax = {"time": (30.0 * np.arange(12) + 15.0)}
    t_attrs = {"time": {"units": "days since 0001-01-01",
                        "modulo": "360"}}
    zyx = ("depth", "ny", "nx")
    tyx = ("time", "ny", "nx")
    return {
        "bgc_restoring.nc": dict(
            z_edges=z_edges, I_TAU=i_tau, **clim,
            dims=dict({"z_edges": ("edge",), "I_TAU": zyx},
                      **{k: zyx for k in clim})),
        "bgc_riv.nc": dict(time_ax, **rivers,
                           dims=dict({"time": ("time",)},
                                     **{k: tyx for k in rivers}),
                           attrs=t_attrs),
        "bgc_dust.nc": dict(time_ax, dust=dust,
                            dims={"time": ("time",), "dust": tyx},
                            attrs=t_attrs),
        "bgc_ndep.nc": dict(time_ax, ndep=ndep,
                            dims={"time": ("time",), "ndep": tyx},
                            attrs=t_attrs),
        "bgc_fesed.nc": {"FESEDFLUX": fesed}}


def write_bgc_inputs(indir: str, ni: int, nj: int, seed: int = 0) -> None:
    """The files of ``bgc_fields`` in ``indir``."""
    import os
    from mom6_torch.framework.io import write_fields
    for name, fields in bgc_fields(ni, nj, seed).items():
        fields = dict(fields)
        dims, attrs = fields.pop("dims", None), fields.pop("attrs", None)
        write_fields(os.path.join(indir, name), fields, dims=dims,
                     attrs=attrs)


def obc_strip(ni: int) -> str:
    """The override of BENCH_CONFIG_OBC's S segment at ``ni`` points:
    the strip over the middle half of the edge."""
    return (f'#override OBC_SEGMENT_003 = "J=0,I={ni // 4}:{3 * ni // 4},'
            'FLATHER,ORLANSKI"\n')


def obc_east_fields(nj: int, seed: int) -> dict:
    """The E segment's data of ``BENCH_CONFIG_OBC`` on an edge of ``nj``
    points: two records, a day apart, of an along-edge inflow profile
    ``u`` (-0.05 m/s with a +-0.01 m/s mode and seeded noise of 2 mm/s)
    and an ssh profile ``ssh`` (a 1 cm tilt with 2 mm of noise), the
    second record a tenth weaker in u and of opposite tilt."""
    rng = np.random.default_rng(seed)
    y = (np.arange(nj) + 0.5) / nj
    u0 = -0.05 + 0.01 * np.sin(2.0 * np.pi * y)
    ssh0 = 0.01 * (y - 0.5)
    u = np.stack([u0, 0.9 * u0]) + 0.002 * rng.standard_normal((2, nj))
    ssh = np.stack([ssh0, -ssh0]) + 0.002 * rng.standard_normal((2, nj))
    return {"time": np.array([0.0, 1.0]), "u": u, "ssh": ssh}


def write_obc_data(indir: str, ni: int, nj: int, seed: int) -> None:
    """``obc_east.nc`` of ``obc_east_fields`` in ``indir``, for a grid of
    ``ni`` x ``nj`` points, with its time axis in days."""
    import os
    from mom6_torch.framework.io import write_fields
    del ni    # the E edge runs along y
    f = obc_east_fields(nj, seed)
    write_fields(os.path.join(indir, "obc_east.nc"), f,
                 dims={"time": ("time",), "u": ("time", "ny"),
                       "ssh": ("time", "ny")},
                 attrs={"time": {"units": "days since 0001-01-01"},
                        "u": {"units": "m s-1"}, "ssh": {"units": "m"}})


def topog_edge_fields(shape, seed: int) -> dict:
    """The six TOPO_AT_VEL fields (positive depths) of ``shape`` for
    bench.py's flat bottom at 4000 m: about a fifth of the U and V faces, drawn
    from ``seed``, carry a ridge whose crest lies 500-3000 m deep and
    whose mean depth lies between the crest and the bottom (Dmin < Davg
    < Dmax as heights); every other face is fully open (crest at the
    surface, mean depth at the bottom)."""
    depth = 4000.0
    rng = np.random.default_rng(seed)
    fields = {}
    for s in "uv":
        ridge = rng.random(shape) < 0.2
        crest = rng.uniform(500.0, 3000.0, shape)
        mean = crest + rng.uniform(0.2, 0.8, shape) * (depth - crest)
        fields[f"depth{s}_hi"] = np.where(ridge, crest, 0.0)
        fields[f"depth{s}_lo"] = np.full(shape, depth)
        fields[f"depth{s}_av"] = np.where(ridge, mean, depth)
    return fields


def write_topog_edge(path: str, ni: int, nj: int, seed: int) -> None:
    """A TOPO_AT_VEL file of ``topog_edge_fields`` on an ``nj`` x ``ni``
    compute domain."""
    from mom6_torch.framework.io import write_fields
    write_fields(path, topog_edge_fields((nj, ni), seed))
