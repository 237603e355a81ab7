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
A test holds each to ``BENCH_CONFIG`` plus exactly its lines.
"""

__all__ = ["BENCH_CONFIG", "BENCH_CONFIG_RK2B", "BENCH_CONFIG_UNSPLIT"]

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
