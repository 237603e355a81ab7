"""Configurations the port ships as text.

``BENCH_CONFIG`` is the port's own copy of bench.py's ``CONFIG``, the
benchmark configuration: a 512x512x25 reentrant channel with Z* ALE,
KPP, GM, MLE, PLM T/S and ideal-age transport, gyre wind and linear
SST restoring.  ``entry.build_full`` builds it through
``model.build_model``; a test holds the text equal to bench.py's.
"""

__all__ = ["BENCH_CONFIG"]

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
