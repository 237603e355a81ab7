"""Carry state between numpy and the port's containers.

Each ``*_from_numpy`` takes a dict of numpy arrays keyed by the field
names of the matching ``mom6_tpu`` container (Grid, State,
SplitDynState, BTContFaces) and returns the port's container on the
given device and dtype; ``to_numpy`` goes back.  Fields that are None
or missing (optional fields only) stay None.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mom6_torch.core.continuity_ppm import BTContFaces
from mom6_torch.core.dynamics_split_rk2 import SplitDynState
from mom6_torch.core.grid import Grid
from mom6_torch.core.state import State
from mom6_torch.parallel.domain import Domain

__all__ = ["grid_from_numpy", "state_from_numpy", "split_state_from_numpy",
           "bt_cont_from_numpy", "to_numpy"]


def _fields(cls):
    if dataclasses.is_dataclass(cls):
        return [(f.name, f.default is dataclasses.MISSING)
                for f in dataclasses.fields(cls)]
    return [(name, name not in cls._field_defaults) for name in cls._fields]


def _build(cls, arrays: dict, device, dtype, **extra):
    kw = dict(extra)
    for name, required in _fields(cls):
        if name in kw:
            continue
        a = arrays.get(name)
        if a is None:
            if required:
                raise KeyError(f"{cls.__name__}: missing field {name!r}")
            kw[name] = None
        else:
            kw[name] = torch.as_tensor(np.array(a), dtype=dtype,
                                       device=device)
    return cls(**kw)


def grid_from_numpy(arrays: dict, domain: Domain, *, device,
                    dtype: torch.dtype) -> Grid:
    return _build(Grid, arrays, device, dtype, domain=domain)


def state_from_numpy(arrays: dict, *, device, dtype: torch.dtype) -> State:
    return _build(State, arrays, device, dtype)


def split_state_from_numpy(arrays: dict, *, device,
                           dtype: torch.dtype) -> SplitDynState:
    return _build(SplitDynState, arrays, device, dtype)


def bt_cont_from_numpy(arrays: dict, *, device,
                       dtype: torch.dtype) -> BTContFaces:
    return _build(BTContFaces, arrays, device, dtype)


def to_numpy(obj) -> dict:
    """{field name: numpy array} for every tensor field of a dataclass or
    NamedTuple."""
    if dataclasses.is_dataclass(obj):
        items = {f.name: getattr(obj, f.name)
                 for f in dataclasses.fields(obj)}
    else:
        items = obj._asdict()
    return {k: v.detach().cpu().numpy() for k, v in items.items()
            if isinstance(v, torch.Tensor)}
