"""TEOS-10 equation of state: the gsw 75-term specific-volume fit.

Counterpart of ``mom6_tpu.eos.teos10``: gsw_specvol, the Roquet, Madec,
McDougall & Barker (2015) 75-term polynomial in absolute salinity SA,
conservative temperature CT and pressure, adopted by TEOS-10, with
density as its reciprocal (or the cancellation-free anomaly of
ROQUET_SPV, which it subclasses) and every derivative through the base
class's forward-mode autodiff.  The model's (T, S) are read as (CT, SA);
``temperature_convert`` converts potential temperature where a dataset
carries it.
"""

from __future__ import annotations

import dataclasses

import torch

from mom6_torch.eos.poly import Poly3
from mom6_torch.eos.roquet import RoquetSpVEOS

__all__ = ["TEOS10EOS"]

# gsw normalizations: xs = sqrt(sfac*SA + offset), ys = CT/40,
# z = p/1e4 dbar (pressure arrives in Pa: 1 dbar = 1e4 Pa)
_SFAC = 0.0248826675584615           # = 1/(40*(35.16504/35)) [kg g-1]
_OFFSET = 5.971840214030754e-1       # = 24 * _SFAC
_I_TS = 1.0 / 40.0                   # [degC-1]
_PA2Z = 1.0 / (1.0e4 * 1.0e4)        # Pa -> dbar -> z = p/1e4

# the 75 coefficients v_ijk of xs^i ys^j z^k [m3 kg-1], as published
# in Roquet et al. (2015) appendix / gsw_mod_specvol_coefficients
_V75 = {
    (0, 0, 0): 1.0769995862e-03, (1, 0, 0): -3.1038981976e-04,
    (2, 0, 0): 6.6928067038e-04, (3, 0, 0): -8.5047933937e-04,
    (4, 0, 0): 5.8086069943e-04, (5, 0, 0): -2.1092370507e-04,
    (6, 0, 0): 3.1932457305e-05,
    (0, 1, 0): -1.5649734675e-05, (1, 1, 0): 3.5009599764e-05,
    (2, 1, 0): -4.3592678561e-05, (3, 1, 0): 3.4532461828e-05,
    (4, 1, 0): -1.1959409788e-05, (5, 1, 0): 1.3864594581e-06,
    (0, 2, 0): 2.7762106484e-05, (1, 2, 0): -3.7435842344e-05,
    (2, 2, 0): 3.5907822760e-05, (3, 2, 0): -1.8698584187e-05,
    (4, 2, 0): 3.8595339244e-06,
    (0, 3, 0): -1.6521159259e-05, (1, 3, 0): 2.4141479483e-05,
    (2, 3, 0): -1.4353633048e-05, (3, 3, 0): 2.2863324556e-06,
    (0, 4, 0): 6.9111322702e-06, (1, 4, 0): -8.7595873154e-06,
    (2, 4, 0): 4.3703680598e-06,
    (0, 5, 0): -8.0539615540e-07, (1, 5, 0): -3.3052758900e-07,
    (0, 6, 0): 2.0543094268e-07,
    (0, 0, 1): -6.0799143809e-05, (1, 0, 1): 2.4262468747e-05,
    (2, 0, 1): -3.4792460974e-05, (3, 0, 1): 3.7470777305e-05,
    (4, 0, 1): -1.7322218612e-05, (5, 0, 1): 3.0927427253e-06,
    (0, 1, 1): 1.8505765429e-05, (1, 1, 1): -9.5677088156e-06,
    (2, 1, 1): 1.1100834765e-05, (3, 1, 1): -9.8447117844e-06,
    (4, 1, 1): 2.5909225260e-06,
    (0, 2, 1): -1.1716606853e-05, (1, 2, 1): -2.3678308361e-07,
    (2, 2, 1): 2.9283346295e-06, (3, 2, 1): -4.8826139200e-07,
    (0, 3, 1): 7.9279656173e-06, (1, 3, 1): -3.4558773655e-06,
    (2, 3, 1): 3.1655306078e-07,
    (0, 4, 1): -3.4102187482e-06, (1, 4, 1): 1.2956717783e-06,
    (0, 5, 1): 5.0736766814e-07,
    (0, 0, 2): 9.9856169219e-06, (1, 0, 2): -5.8484432984e-07,
    (2, 0, 2): -4.8122251597e-06, (3, 0, 2): 4.9263106998e-06,
    (4, 0, 2): -1.7811974727e-06,
    (0, 1, 2): -1.1736386731e-06, (1, 1, 2): -5.5699154557e-06,
    (2, 1, 2): 5.4620748834e-06, (3, 1, 2): -1.3544185627e-06,
    (0, 2, 2): 2.1305028740e-06, (1, 2, 2): 3.9137387080e-07,
    (2, 2, 2): -6.5731104067e-07,
    (0, 3, 2): -4.6132540037e-07, (1, 3, 2): 7.7618888092e-09,
    (0, 4, 2): -6.3352916514e-08,
    (0, 0, 3): -1.1309361437e-06, (1, 0, 3): 3.6310188515e-07,
    (2, 0, 3): 1.6746303780e-08,
    (0, 1, 3): -3.6527006553e-07, (1, 1, 3): -2.7295696237e-07,
    (0, 2, 3): 2.8695905159e-07,
    (0, 0, 4): 1.0531153080e-07, (1, 0, 4): -1.1147125423e-07,
    (0, 1, 4): 3.1454099902e-07,
    (0, 0, 5): -1.2647261286e-08,
    (0, 0, 6): 1.9613503930e-09,
}

_V75_POLY = Poly3(_V75)


@dataclasses.dataclass(frozen=True)
class TEOS10EOS(RoquetSpVEOS):
    name = "TEOS10"

    def spec_vol(self, T, S, p, spv_ref: float = 0.0):
        xs = torch.sqrt(torch.clamp(_SFAC * S + _OFFSET, min=0.0))
        return _V75_POLY(xs, T * _I_TS, p * _PA2Z) - spv_ref
