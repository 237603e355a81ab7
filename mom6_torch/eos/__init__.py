"""Equations of state for seawater.

Counterpart of ``mom6_tpu.eos``: each EOS is a small object with
vectorized ``density(T, S, p)`` and ``density_derivs`` methods on whole
tensors.  The linear and Wright (1997) forms are ported; the other
EQN_OF_STATE forms of the JAX package raise ``NotImplementedError``.
"""

from __future__ import annotations

from mom6_torch.eos.base import EOS
from mom6_torch.eos.linear import LinearEOS
from mom6_torch.eos.wright import WrightEOS, WrightFullEOS, WrightRedEOS

__all__ = ["EOS", "LinearEOS", "WrightEOS", "WrightFullEOS", "WrightRedEOS",
           "make_eos"]

_REGISTRY = {
    "LINEAR": LinearEOS,
    "WRIGHT": WrightEOS,
    "WRIGHT_FULL": WrightFullEOS,
    "WRIGHT_RED": WrightRedEOS,
}
_NOT_PORTED = ("UNESCO", "JACKETT_06", "ROQUET_RHO", "ROQUET_SPV", "TEOS10")


def make_eos(form: str = "WRIGHT", **kw) -> EOS:
    """EOS factory keyed on the EQN_OF_STATE strings."""
    key = form.upper()
    if key in _NOT_PORTED:
        raise NotImplementedError(f"EQN_OF_STATE {key}")
    if key not in _REGISTRY:
        raise ValueError(f"Unknown EQN_OF_STATE '{form}'; known: "
                         + ", ".join(sorted(_REGISTRY)))
    return _REGISTRY[key](**kw)
