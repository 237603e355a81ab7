"""The slice's model builder: the split RK2 dynamics step of the
flagship configuration at the width and depth of the benchmark's
dynamics core.

``build`` returns everything ``step_dyn_split_rk2`` needs:

* 512x512 interior, 25 layers, halo 4 (25x520x520 arrays), reentrant
  in x with walls in y, 10 km cartesian spacing, flat bottom at
  4000 m, f0 = 1e-4, beta = 2e-11, VerticalGrid.uniform(gint=0.005);
* layered reduced-gravity pressure force (no equation of state);
* dt = 600 s, Kv = 1e-4, biharmonic Smagorinsky viscosity (0.06),
  BT_cont curves and the barotropic substep count from set_dtbt
  (27 at this depth and spacing);
* wind stress taux = 0.1 Pa on wet u faces;
* h = 4000/nk plus a seeded perturbation of a few metres, u = v = 0.

The tests build the same configuration at a few points and layers.
Runs on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mom6_torch.core.barotropic import BarotropicCfg, set_dtbt
from mom6_torch.core.dynamics_split_rk2 import (SplitCfg, SplitDynState,
                                                init_split_state)
from mom6_torch.core.forcing import MechForcing
from mom6_torch.core.grid import Grid, cartesian_grid
from mom6_torch.core.state import State
from mom6_torch.core.vert_friction import VertViscCfg
from mom6_torch.core.vertical_grid import VerticalGrid
from mom6_torch.param.lateral.hor_visc import HorViscCfg
from mom6_torch.parallel.domain import Domain

__all__ = ["Slice", "build"]

DT = 600.0
DEPTH = 4000.0


@dataclasses.dataclass(frozen=True)
class Slice:
    domain: Domain
    grid: Grid
    vgrid: VerticalGrid
    cfg: SplitCfg
    state: State
    split: SplitDynState
    forces: MechForcing
    dt: float


def build(ni: int = 512, nj: int = 512, nk: int = 25, *, seed: int = 0,
          device="cuda", dtype: torch.dtype = torch.float32) -> Slice:
    """The slice's configuration with its initial state."""
    d = Domain(ni=ni, nj=nj, halo=4, reentrant_x=True, reentrant_y=False)
    g = cartesian_grid(d, lenlon_km=ni * 10.0, lenlat_km=nj * 10.0,
                       f0=1e-4, beta=2e-11, max_depth=DEPTH,
                       device=device, dtype=dtype)
    vg = VerticalGrid.uniform(nk=nk, gint=0.005, device=device,
                              dtype=dtype)
    nstep = set_dtbt(d, g, vg, BarotropicCfg(), DT)
    cfg = SplitCfg(vertvisc=VertViscCfg(kv=1e-4),
                   horvisc=HorViscCfg(biharmonic=True, smag_bi_const=0.06,
                                      dt=DT),
                   barotropic=BarotropicCfg(nstep=nstep))
    rng = np.random.default_rng(seed)
    h0 = DEPTH / nk + 2.0 * rng.standard_normal((nk, nj, ni))
    h = d.fill_halos(d.pad(torch.as_tensor(h0, dtype=dtype,
                                           device=device)))
    z = torch.zeros_like(h)
    state = State(u=z, v=z, h=h)
    split = init_split_state(d, g, vg, state)
    forces = MechForcing(taux=0.1 * g.mask2dCu)
    return Slice(d, g, vg, cfg, state, split, forces, DT)
