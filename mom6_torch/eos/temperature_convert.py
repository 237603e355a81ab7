"""Conservative <-> potential temperature conversion (TEOS-10).

Counterpart of ``mom6_tpu.eos.temperature_convert`` (the gsw toolbox's
gsw_ct_from_pt and gsw_pt_from_ct): the published IOC et al. (2010)
Gibbs-function fit constants.  Conservative temperature is the model's
prognostic temperature under the ROQUET_* and TEOS10 equations of
state; potential temperature is what most initial-condition and
boundary datasets carry.  Every function is elementwise on tensors, and
the inverse is the fixed 1.5-step Newton-McDougall iteration, with no
data-dependent control flow.  The model itself calls none of them.
"""

from __future__ import annotations

import torch

__all__ = ["poTemp_to_consTemp", "consTemp_to_poTemp", "dTc_dTp"]

_SPRAC_SREF = 35.0 / 35.16504     # reference → practical salinity
_I_S0 = 0.025 * _SPRAC_SREF       # inverse salinity range [kg g-1]
_I_TS = 0.025                     # inverse temperature range [degC-1]
_I_CP0 = 1.0 / 3991.86795711963   # 1/cp0 as defined by TEOS-10

# contributions Hab * zS**a * T**b to conservative temperature, where
# zS = sqrt(I_S0 * Sa); values from the TEOS-10 Gibbs-function fit
_H0 = [61.01362420681071 * _I_CP0,
       168776.46138048015 * (_I_CP0 * _I_TS),
       -2735.2785605119625 * (_I_CP0 * _I_TS ** 2),
       2574.2164453821433 * (_I_CP0 * _I_TS ** 3),
       -1536.6644434977543 * (_I_CP0 * _I_TS ** 4),
       545.7340497931629 * (_I_CP0 * _I_TS ** 5),
       -50.91091728474331 * (_I_CP0 * _I_TS ** 6),
       -18.30489878927802 * (_I_CP0 * _I_TS ** 7)]
_H2 = [268.5520265845071 * _I_CP0,
       -12019.028203559312 * (_I_CP0 * _I_TS),
       3734.858026725145 * (_I_CP0 * _I_TS ** 2),
       -2046.7671145057618 * (_I_CP0 * _I_TS ** 3),
       465.28655623826234 * (_I_CP0 * _I_TS ** 4),
       -0.6370820302376359 * (_I_CP0 * _I_TS ** 5),
       -10.650848542359153 * (_I_CP0 * _I_TS ** 6)]
_H3 = [937.2099110620707 * _I_CP0,
       588.1802812170108 * (_I_CP0 * _I_TS),
       248.39476522971285 * (_I_CP0 * _I_TS ** 2),
       -3.871557904936333 * (_I_CP0 * _I_TS ** 3),
       -2.6268019854268356 * (_I_CP0 * _I_TS ** 4)]
_H4 = [-1687.914374187449 * _I_CP0,
       936.3206544460336 * (_I_CP0 * _I_TS),
       -942.7827304544439 * (_I_CP0 * _I_TS ** 2),
       369.4389437509002 * (_I_CP0 * _I_TS ** 3),
       -33.83664947895248 * (_I_CP0 * _I_TS ** 4),
       -9.987880382780322 * (_I_CP0 * _I_TS ** 5)]
_H50 = 246.9598888781377 * _I_CP0
_H60 = 123.59576582457964 * _I_CP0
_H70 = -48.5891069025409 * _I_CP0


def _poly(T, coefs):
    out = coefs[-1]
    for c in coefs[-2::-1]:
        out = c + T * out
    return out


def poTemp_to_consTemp(T, Sa):
    """Potential temperature [degC] and absolute salinity [g kg-1] to
    conservative temperature [degC]."""
    x2 = torch.clamp(_I_S0 * Sa, min=0.0)
    x = torch.sqrt(x2)
    return (_poly(T, _H0)
            + x2 * (_poly(T, _H2)
                    + x * (_poly(T, _H3)
                           + x * (_poly(T, _H4)
                                  + x * (_H50 + x * (_H60
                                                     + x * _H70))))))


def dTc_dTp(T, Sa):
    """d(conservative T)/d(potential T) [nondim]."""
    def dpoly(T, coefs):
        out = (len(coefs) - 1) * coefs[-1]
        for n in range(len(coefs) - 2, 0, -1):
            out = n * coefs[n] + T * out
        return out
    x2 = torch.clamp(_I_S0 * Sa, min=0.0)
    x = torch.sqrt(x2)
    return (dpoly(T, _H0)
            + x2 * (dpoly(T, _H2)
                    + x * (dpoly(T, _H3) + x * dpoly(T, _H4))))


# rational first-guess fit for the inverse (gsw_pt_from_ct)
_TPN00 = -1.446013646344788e-2
_TPN10 = -3.305308995852924e-3 * _SPRAC_SREF
_TPN20 = 1.062415929128982e-4 * _SPRAC_SREF ** 2
_TPN01 = 9.477566673794488e-1
_TPN11 = 2.166591947736613e-3 * _SPRAC_SREF
_TPN02 = 3.828842955039902e-3
_TPD10 = 6.506097115635800e-4 * _SPRAC_SREF
_TPD01 = 3.830289486850898e-3
_TPD02 = 1.247811760368034e-6


def consTemp_to_poTemp(Tc, Sa):
    """Conservative temperature [degC] and absolute salinity [g kg-1]
    to potential temperature [degC] by the fixed 1.5-iteration
    Newton-McDougall inversion."""
    tp_num = _TPN00 + (Sa * (_TPN10 + _TPN20 * Sa)
                       + Tc * (_TPN01 + (_TPN11 * Sa + _TPN02 * Tc)))
    i_tp_den = 1.0 / (1.0 + (_TPD10 * Sa
                             + Tc * (_TPD01 + _TPD02 * Tc)))
    tp = tp_num * i_tp_den
    dtp_dtc = ((_TPN01 + (_TPN11 * Sa + 2.0 * _TPN02 * Tc))
               - (_TPD01 + 2.0 * _TPD02 * Tc) * tp) * i_tp_den

    tc_diff = poTemp_to_consTemp(tp, Sa) - Tc
    tp_old = tp
    tp = tp_old - tc_diff * dtp_dtc

    dtp_dtc = 1.0 / dTc_dTp(0.5 * (tp + tp_old), Sa)
    tp = tp_old - tc_diff * dtp_dtc
    tc_diff = poTemp_to_consTemp(tp, Sa) - Tc
    tp_old = tp
    return tp_old - tc_diff * dtp_dtc
