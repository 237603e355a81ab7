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

A test holds each to ``BENCH_CONFIG`` plus exactly its lines.
"""

import numpy as np

__all__ = ["BENCH_CONFIG", "BENCH_CONFIG_RK2B", "BENCH_CONFIG_UNSPLIT",
           "BENCH_CONFIG_B1", "BENCH_CONFIG_NONBOUSS", "B1_LINES",
           "NONBOUSS_LINES", "topog_edge_fields", "write_topog_edge"]

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

BENCH_CONFIG_B1 = BENCH_CONFIG + B1_LINES

BENCH_CONFIG_NONBOUSS = BENCH_CONFIG + NONBOUSS_LINES


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
