"""Tracer registry (counterpart of ``mom6_tpu.tracer.registry``): named
tracers with metadata and an optional per-step column function; the
tracer data lives in a plain ``dict[str, Tensor]`` beside the state."""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

__all__ = ["TracerMeta", "TracerRegistry"]


@dataclasses.dataclass
class TracerMeta:
    name: str
    longname: str = ""
    units: str = ""
    registry_diffuse: bool = True     # participate in lateral diffusion
    advect: bool = True
    restart: bool = True
    # optional per-step column physics: fn(tracer, h, dt, **ctx) → tracer
    column_fn: Optional[Callable] = None


class TracerRegistry:
    def __init__(self):
        self._meta: dict[str, TracerMeta] = {}

    def register(self, meta: TracerMeta):
        if meta.name in self._meta:
            raise ValueError(f"tracer '{meta.name}' already registered")
        self._meta[meta.name] = meta
        return meta

    def names(self, advected_only: bool = False):
        if advected_only:
            return [n for n, m in self._meta.items() if m.advect]
        return list(self._meta)

    def meta(self, name: str) -> TracerMeta:
        return self._meta[name]

    def apply_column_fns(self, tracers: dict, h, dt, **ctx) -> dict:
        out = dict(tracers)
        for name, m in self._meta.items():
            if m.column_fn is not None and name in out:
                out[name] = m.column_fn(out[name], h, dt, **ctx)
        return out
