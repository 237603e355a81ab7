"""Carry state and configuration between numpy / plain values and the
port's containers.

Each ``*_from_numpy`` takes a dict of numpy arrays keyed by the field
names of the matching ``mom6_tpu`` container (Grid, State,
SplitDynState, SplitBDynState, BTContFaces, ShelfState) and returns the
port's container on the given device and dtype; ``tracers_from_numpy`` does the same for a
tracer dict, and ``sal_from_numpy`` for the SAL operator's basis,
weights, Love scaling and shape; ``to_numpy`` goes back.  Fields that are None or missing
(optional fields only) stay None.  ``model_with_state`` carries a whole
initial state (state, split state, tracers) into a port ``Model`` on
that model's device and dtype.

``config_from_values`` builds one of the port's configuration
dataclasses from a nested dict of plain values keyed like the JAX
package's (``dataclasses.asdict`` of a ``mom6_tpu`` config, the
ice shelf's ``ShelfCfg``, ``SSACfg`` and ``IceShelfCfg`` among them): the
fields the port has are taken over, and every other key must hold its
default (the matching entry of ``defaults``), unless it is one of the
JAX package's switches between a Pallas kernel and its jnp path (the
port's kernel wrappers choose by the tensor's device).  A
key that sets an option the port lacks raises ``NotImplementedError``
naming it.
"""

from __future__ import annotations

import dataclasses
import typing

import numpy as np
import torch

from mom6_torch.core.continuity_ppm import BTContFaces
from mom6_torch.core.dynamics_split_rk2 import SplitDynState
from mom6_torch.core.dynamics_split_rk2b import SplitBDynState
from mom6_torch.core.grid import Grid
from mom6_torch.core.state import State
from mom6_torch.ice_shelf.shelf_main import ShelfState
from mom6_torch.param.lateral.self_attr_load import SALHarmonics
from mom6_torch.parallel.domain import Domain

__all__ = ["grid_from_numpy", "state_from_numpy", "split_state_from_numpy",
           "split_b_state_from_numpy", "bt_cont_from_numpy", "tracers_from_numpy",
           "shelf_state_from_numpy",
           "sal_from_numpy", "model_with_state",
           "config_from_values", "to_numpy"]


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


def split_b_state_from_numpy(arrays: dict, *, device,
                             dtype: torch.dtype) -> SplitBDynState:
    return _build(SplitBDynState, arrays, device, dtype)


def bt_cont_from_numpy(arrays: dict, *, device,
                       dtype: torch.dtype) -> BTContFaces:
    return _build(BTContFaces, arrays, device, dtype)


def shelf_state_from_numpy(arrays: dict, *, device,
                           dtype: torch.dtype) -> ShelfState:
    return _build(ShelfState, arrays, device, dtype)


def tracers_from_numpy(arrays: dict, *, device,
                       dtype: torch.dtype) -> dict:
    return {k: torch.as_tensor(np.array(v), dtype=dtype, device=device)
            for k, v in arrays.items()}


def sal_from_numpy(arrays: dict, *, device,
                   dtype: torch.dtype) -> SALHarmonics:
    """The SAL operator from a dict of ``basis``, ``weights``, ``love``
    and ``shape`` (the fields of the JAX package's SALHarmonics)."""
    return SALHarmonics(**{
        k: torch.as_tensor(np.array(arrays[k]), dtype=dtype, device=device)
        for k in ("basis", "weights", "love")},
        shape=tuple(int(n) for n in arrays["shape"]))


def model_with_state(model, state: dict, split: dict | None = None,
                     tracers: dict | None = None):
    """A copy of the port ``Model`` whose initial state, split state and
    tracers come from the given numpy dicts (those not given are kept);
    the split state takes the type of the model's own (RK2 or RK2b)."""
    dev = dict(device=model.state.h.device, dtype=model.state.h.dtype)
    kw = {"state": state_from_numpy(state, **dev)}
    if split is not None:
        kw["split"] = (split_b_state_from_numpy(split, **dev)
                       if isinstance(model.split, SplitBDynState)
                       else split_state_from_numpy(split, **dev))
    if tracers is not None:
        kw["tracers"] = tracers_from_numpy(tracers, **dev)
    return dataclasses.replace(model, **kw)


_KERNEL_SWITCHES = ("use_pallas", "use_pallas_fused")


def _dataclass_type(hint):
    """The dataclass in a field's type hint (``X`` or ``Optional[X]``),
    else None."""
    for t in (hint, *typing.get_args(hint)):
        if isinstance(t, type) and dataclasses.is_dataclass(t):
            return t
    return None


def config_from_values(cls, values: dict, defaults: dict, path: str = ""):
    """An instance of the port's config dataclass ``cls`` from the nested
    plain ``values``; ``defaults`` holds the JAX package's default for
    every key of ``values`` (nested alike)."""
    hints = typing.get_type_hints(cls)
    names = {f.name for f in dataclasses.fields(cls)}
    kw = {}
    for key, val in values.items():
        where = f"{path}{key}"
        if key in names:
            sub = _dataclass_type(hints[key])
            if sub is not None and isinstance(val, dict):
                val = config_from_values(sub, val, defaults.get(key) or {},
                                         where + ".")
            elif isinstance(val, list):
                val = tuple(val)
            kw[key] = val
        elif key in _KERNEL_SWITCHES:
            continue
        elif val != defaults.get(key, object()):
            raise NotImplementedError(
                f"{where} = {val!r}: option not ported")
    return cls(**kw)


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
