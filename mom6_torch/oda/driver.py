"""The ensemble forecast-analysis cycle.

Counterpart of ``mom6_tpu.oda.driver``: member states from the model's
initial state with seeded temperature perturbations, then cycles of a
forecast of every member through ``step_ocean`` and a perturbed-
observation EnKF update of the top layer's temperature against one SST
observation.  The JAX package vmaps the members' step into one program;
on its one card the port steps the members in turn, so the step's
temporaries are one member's and the ensemble adds its states alone.
The x_first of a step alternates with the global step count n, x first
on odd n, as in the JAX driver.
"""

from __future__ import annotations

import dataclasses

import torch

from mom6_torch.core.orchestrator import step_ocean
from mom6_torch.framework import random as prandom
from mom6_torch.oda.ensemble import (EnsembleCfg, enkf_analysis, member,
                                     stack_members)

__all__ = ["OdaRun", "init_ensemble_states", "run_oda_cycles"]


@dataclasses.dataclass
class OdaRun:
    """The result of a run of cycles."""
    states: object            # the members' State, stacked on axis 0
    splits: object            # their split states, stacked
    sst_mean: list            # each cycle's ensemble-mean SST at the obs
    sst_spread: list          # and its spread


def init_ensemble_states(model, ne: int, t_pert: float = 0.5,
                         seed: int = 0):
    """(states, splits) of ``ne`` members stacked on a leading axis: the
    model's initial state with T perturbed by ``t_pert`` times standard
    normals drawn in T's dtype from fold_in(key(seed), m), masked by
    mask2dT, and the model's split state repeated."""
    st0 = model.state
    states = []
    for m in range(ne):
        st = st0
        if st.T is not None:
            noise = t_pert * prandom.normal(
                prandom.fold_in(prandom.key(seed), m), st.T.shape,
                dtype=st.T.dtype, device=st.T.device)
            st = st.replace(T=st.T + noise * model.grid.mask2dT)
        states.append(st)
    return stack_members(states), stack_members([model.split] * ne)


def run_oda_cycles(model, ens_cfg: EnsembleCfg, n_cycles: int,
                   steps_per_cycle: int, obs_values, obs_ji: tuple,
                   t_pert: float = 0.5, seed: int = 0) -> OdaRun:
    """``n_cycles`` forecast-analysis cycles of the ensemble.

    ``obs_values``: each cycle's observed SST at the grid point
    ``obs_ji`` (j, i of the padded arrays).  Each cycle steps every
    member ``steps_per_cycle`` times (the model's static wind, no
    buoyancy fluxes, no tracers, every step thermodynamic, as the JAX
    driver steps them), then updates the top layer's T of every member
    by ``enkf_analysis`` against the cycle's observation.  The cycle's
    ensemble mean and spread of the SST at the observation are read
    once a cycle (the only host syncs)."""
    d, g, vg = model.domain, model.grid, model.vgrid
    cfg, eos, dt, forces = model.cfg, model.eos, model.dt, model.forces
    ne = ens_cfg.ensemble_size
    states, splits = init_ensemble_states(model, ne, t_pert, seed)
    members = [(member(states, m), member(splits, m)) for m in range(ne)]
    del states, splits          # the members' views hold what they need
    jo, io = obs_ji
    sst_mean, sst_spread = [], []
    n = 0
    for cyc in range(n_cycles):
        for _ in range(steps_per_cycle):
            for m, (st, sp) in enumerate(members):
                st, sp, _, _ = step_ocean(d, g, vg, st, sp, None, forces,
                                          None, dt, cfg, eos=eos,
                                          x_first=bool(n % 2))
                members[m] = (st, sp)
            n += 1
        T = torch.stack([st.T for st, _ in members])
        t0 = enkf_analysis(ens_cfg, T[:, 0].reshape(ne, -1),
                           obs_values[cyc], jo * T.shape[-1] + io)
        t0 = t0.reshape(ne, *T.shape[2:]).to(T.dtype)
        members = [(st.replace(T=torch.cat([t0[m][None], st.T[1:]])), sp)
                   for m, (st, sp) in enumerate(members)]
        sst = t0[:, jo, io]
        sst_mean.append(float(torch.mean(sst)))
        sst_spread.append(float(torch.std(sst, correction=0)))
    return OdaRun(states=stack_members([st for st, _ in members]),
                  splits=stack_members([sp for _, sp in members]),
                  sst_mean=sst_mean, sst_spread=sst_spread)
