"""Equations of state for seawater.

Counterpart of ``mom6_tpu.eos``: each EOS is a small object with
vectorized ``density(T, S, p)``, ``spec_vol`` and derivative methods on
whole tensors, for every EQN_OF_STATE form of the JAX package: LINEAR,
the three Wright (1997) forms, UNESCO, JACKETT_06, the Roquet (2015)
density and specific-volume polynomials and TEOS10.  UNESCO and
JACKETT_06 give NaN derivatives in S at S = 0, as the JAX package does.
"""

from __future__ import annotations

from mom6_torch.eos.base import EOS
from mom6_torch.eos.jackett06 import Jackett06EOS
from mom6_torch.eos.linear import LinearEOS
from mom6_torch.eos.roquet import RoquetRhoEOS, RoquetSpVEOS
from mom6_torch.eos.teos10 import TEOS10EOS
from mom6_torch.eos.unesco import UnescoEOS
from mom6_torch.eos.wright import WrightEOS, WrightFullEOS, WrightRedEOS

__all__ = ["EOS", "LinearEOS", "WrightEOS", "WrightFullEOS", "WrightRedEOS",
           "UnescoEOS", "Jackett06EOS", "RoquetRhoEOS", "RoquetSpVEOS",
           "TEOS10EOS", "make_eos"]

_REGISTRY = {
    "LINEAR": LinearEOS,
    "WRIGHT": WrightEOS,
    "WRIGHT_FULL": WrightFullEOS,
    "WRIGHT_RED": WrightRedEOS,
    "UNESCO": UnescoEOS,
    "JACKETT_06": Jackett06EOS,
    "ROQUET_RHO": RoquetRhoEOS,
    "ROQUET_SPV": RoquetSpVEOS,
    "TEOS10": TEOS10EOS,
}


def make_eos(form: str = "WRIGHT", **kw) -> EOS:
    """EOS factory keyed on the EQN_OF_STATE strings."""
    key = form.upper()
    if key not in _REGISTRY:
        raise ValueError(f"Unknown EQN_OF_STATE '{form}'; known: "
                         + ", ".join(sorted(_REGISTRY)))
    return _REGISTRY[key](**kw)
