"""Idealized tracer packages (counterpart of ``mom6_tpu.tracer.ideal``):
the ideal ventilation age and the dyed open-boundary tracers.  The other
packages of the JAX module are not ported yet."""

from __future__ import annotations

import torch

from mom6_torch.tracer.registry import TracerMeta, TracerRegistry

__all__ = ["register_ideal_age", "register_dyed_obc_tracers",
           "age_column"]

_YEAR = 365.0 * 86400.0


def age_column(tr, h, dt, **ctx):
    """The age tracer's column physics: every cell ages by dt [years],
    the surface layer is reset to 0 (ideal_age_example)."""
    tr = tr + dt / _YEAR
    return torch.cat([torch.zeros_like(tr[:1]), tr[1:]], dim=0)


def register_ideal_age(reg: TracerRegistry, shape, *, device,
                       dtype: torch.dtype) -> torch.Tensor:
    """Register the ideal age [years]; returns its zero initial field."""
    reg.register(TracerMeta(name="age", longname="ideal age", units="yr",
                            column_fn=age_column))
    return torch.zeros(shape, device=device, dtype=dtype)


def register_dyed_obc_tracers(reg: TracerRegistry, shape, n_dye: int, *,
                              device, dtype: torch.dtype) -> dict:
    """dye_01..dye_NN, initially zero; each open-boundary segment
    supplies a unit concentration of its own dye."""
    out = {}
    for m in range(1, n_dye + 1):
        name = f"dye_{m:02d}"
        reg.register(TracerMeta(name=name,
                                longname=f"dyed_obc tracer {m:02d}",
                                units="nondim"))
        out[name] = torch.zeros(shape, device=device, dtype=dtype)
    return out
