"""Ensemble management and ocean data assimilation.

Counterpart of ``mom6_tpu.oda.ensemble``: ensemble members carried as a
leading axis of every tensor of a state (a dataclass, dict, tuple or
list of tensors, None leaves passing through), ensemble statistics as
reductions over that axis, a perturbed-observation EnKF of one scalar
observation with multiplicative inflation, and the incremental update
that spreads an analysis increment over a number of steps.  Where the
JAX package vmaps a step over the members, the port steps them in
turn on its one device (``propagate_ensemble``), so a step's
temporaries are held for one member at a time.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from mom6_torch.framework import random as prandom

__all__ = ["EnsembleCfg", "propagate_ensemble", "ensemble_stats",
           "enkf_analysis", "IncrementalUpdate", "stack_members",
           "member"]


@dataclasses.dataclass(frozen=True)
class EnsembleCfg:
    ensemble_size: int = 4
    inflation: float = 1.02        # multiplicative spread inflation
    obs_error: float = 0.1


def _map(fn, *trees):
    """``fn`` over the tensor leaves of trees of one structure."""
    t0 = trees[0]
    if t0 is None:
        return None
    if isinstance(t0, torch.Tensor):
        return fn(*trees)
    if dataclasses.is_dataclass(t0):
        return dataclasses.replace(t0, **{
            f.name: _map(fn, *(getattr(t, f.name) for t in trees))
            for f in dataclasses.fields(t0)})
    if isinstance(t0, dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (tuple, list)):
        return type(t0)(_map(fn, *xs) for xs in zip(*trees))
    raise TypeError(f"unsupported ensemble leaf {type(t0).__name__}")


def stack_members(trees: list):
    """One tree with the members' tensors stacked on a leading axis."""
    return _map(lambda *xs: torch.stack(xs), *trees)


def member(tree, m: int):
    """Member ``m`` of a stacked tree."""
    return _map(lambda x: x[m], tree)


def propagate_ensemble(step_fn: Callable, states, n_steps: int = 1):
    """Advance every member of the stacked ``states`` ``n_steps`` times
    by ``step_fn``, the members in turn."""
    ne = _first_leaf(states).shape[0]
    for _ in range(n_steps):
        states = stack_members([step_fn(member(states, m))
                                for m in range(ne)])
    return states


def _first_leaf(tree):
    out = []
    _map(lambda x: out.append(x) or x, tree)
    return out[0]


def ensemble_stats(field):
    """(mean, spread) over the leading ensemble axis (the spread the
    population standard deviation)."""
    return torch.mean(field, dim=0), torch.std(field, dim=0, correction=0)


def enkf_analysis(cfg: EnsembleCfg, field, obs_value, obs_index: int):
    """The perturbed-observation ensemble Kalman update of ``field``
    (ne, ...) against one observation ``obs_value`` of its value at the
    flat index ``obs_index`` of the non-ensemble axes.  Member m's
    observation perturbation is ``obs_error`` times a standard normal
    of the key fold_in(key(0), m), in float64, as the JAX package draws
    it; the update comes back in float64 where the field is float32,
    as JAX's promotion gives it."""
    ne = field.shape[0]
    flat = field.reshape(ne, -1)
    hx = flat[:, obs_index]
    hx_mean = torch.mean(hx)
    x_mean = torch.mean(flat, dim=0)
    x_pert = (flat - x_mean) * cfg.inflation
    hx_pert = hx - hx_mean
    var_hx = torch.mean(hx_pert ** 2)
    cov_xh = torch.mean(x_pert * hx_pert[:, None], dim=0)
    gain = cov_xh / (var_hx + cfg.obs_error ** 2)
    k0 = prandom.key(0)
    obs_pert = cfg.obs_error * torch.stack([
        prandom.normal(prandom.fold_in(k0, m), device=field.device)
        for m in range(ne)])
    innov = (obs_pert + obs_value) - hx
    new = x_mean[None] + x_pert + innov[:, None] * gain[None]
    return new.reshape(field.shape)


@dataclasses.dataclass
class IncrementalUpdate:
    """An analysis increment applied in equal parts over ``n_steps``
    steps (oda_incupd)."""
    increment: dict            # {field name: the whole increment}
    n_steps: int

    def apply(self, fields: dict, step: int) -> dict:
        if step >= self.n_steps:
            return fields
        frac = 1.0 / self.n_steps
        return {k: (v + frac * self.increment[k] if k in self.increment
                    else v) for k, v in fields.items()}
