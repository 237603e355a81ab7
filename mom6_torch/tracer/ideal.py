"""Idealized tracer packages (counterpart of ``mom6_tpu.tracer.ideal``):
the ideal ventilation age.  The other packages of the JAX module are
not ported yet."""

from __future__ import annotations

import torch

from mom6_torch.tracer.registry import TracerMeta, TracerRegistry

__all__ = ["register_ideal_age", "age_column"]

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
