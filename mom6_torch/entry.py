"""Model set-up of the port: configuration, forcing and initial state.

``build_full`` builds the full ocean step of the benchmark
configuration, bench.py's CONFIG (Z* ALE) with BT_WIDE_HALO_PERIOD = 2
(the barotropic solve on the wide-halo march, kernel K3m), or its
layered variant (USE_REGRIDDING = False), on the split RK2 dynamics or,
with ``dynamics``, the split RK2b or the unsplit RK3 dynamics, or the
first breadth item's options on the split RK2 dynamics
(``configs.BENCH_CONFIG_B1``, ``BENCH_CONFIG_NONBOUSS``), or the
regional configuration with open boundaries (``BENCH_CONFIG_OBC``),
or the rest of the first breadth item (``BENCH_CONFIG_STOCH``), or the
column physics of the third (``BENCH_CONFIG_B3`` with Z* ALE,
``BENCH_CONFIG_BML`` layered), or the fourth (``BENCH_CONFIG_B4`` with Z*
ALE, ``BENCH_CONFIG_B4V`` layered), or the other equations of state and
hybrid coordinates of the fifth and sixth (``BENCH_CONFIG_HYBGEN``,
``BENCH_CONFIG_ADAPT``, ``BENCH_CONFIG_UNMIX``), through
``model.build_model``; its ``Model.step_fn`` steps it.

``build`` returns everything the slice-1 path, ``step_dyn_split_rk2``
alone, needs:

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
import os
import tempfile

import numpy as np
import torch

from mom6_torch.configs import (BENCH_CONFIG, BENCH_CONFIG_ADAPT,
                                BENCH_CONFIG_B1, BENCH_CONFIG_B3,
                                BENCH_CONFIG_B4, BENCH_CONFIG_B4V,
                                BENCH_CONFIG_BGC, BENCH_CONFIG_BML,
                                BENCH_CONFIG_FILE, BENCH_CONFIG_HURR,
                                BENCH_CONFIG_HYBGEN,
                                BENCH_CONFIG_NONBOUSS, BENCH_CONFIG_OBC,
                                BENCH_CONFIG_RK2B, BENCH_CONFIG_SHELF,
                                BENCH_CONFIG_STOCH,
                                BENCH_CONFIG_UNMIX, BENCH_CONFIG_UNSPLIT,
                                obc_strip, write_bgc_inputs,
                                write_file_inputs, write_obc_data,
                                write_topog_edge)
from mom6_torch.core.barotropic import BarotropicCfg, set_dtbt
from mom6_torch.core.dynamics_split_rk2 import (SplitCfg, SplitDynState,
                                                init_split_state)
from mom6_torch.core.dynamics_split_rk2b import init_split_b_state
from mom6_torch.core.forcing import MechForcing
from mom6_torch.core.grid import Grid, cartesian_grid
from mom6_torch.core.state import State
from mom6_torch.core.vert_friction import VertViscCfg
from mom6_torch.core.vertical_grid import VerticalGrid
from mom6_torch.framework.config import ParamFile
from mom6_torch.model import Model, build_model
from mom6_torch.param.lateral.hor_visc import HorViscCfg
from mom6_torch.parallel.domain import Domain

__all__ = ["Slice", "build", "build_full"]

DT = 600.0
DEPTH = 4000.0
# the configuration text of each dynamics of build_full
DYNAMICS = {"rk2": BENCH_CONFIG, "rk2b": BENCH_CONFIG_RK2B,
            "unsplit": BENCH_CONFIG_UNSPLIT, "b1": BENCH_CONFIG_B1,
            "nonbouss": BENCH_CONFIG_NONBOUSS, "obc": BENCH_CONFIG_OBC,
            "stoch": BENCH_CONFIG_STOCH, "b3": BENCH_CONFIG_B3,
            "b3pp81": BENCH_CONFIG_B3 + "#override USE_JACKSON_PARAM = False\n"
            "USE_PP81 = True\n",
            "bml": BENCH_CONFIG_BML, "b4": BENCH_CONFIG_B4,
            "b4v": BENCH_CONFIG_B4V, "hybgen": BENCH_CONFIG_HYBGEN,
            "adapt": BENCH_CONFIG_ADAPT, "unmix": BENCH_CONFIG_UNMIX,
            "file": BENCH_CONFIG_FILE, "bgc": BENCH_CONFIG_BGC,
            "shelf": BENCH_CONFIG_SHELF, "hurr": BENCH_CONFIG_HURR}
# the texts on the split RK2 dynamics
SPLIT_RK2 = ("rk2", "b1", "nonbouss", "obc", "stoch", "b3", "b3pp81", "bml",
             "b4", "b4v", "hybgen", "adapt", "unmix", "file", "bgc", "shelf",
             "hurr")
# the texts that read files from INPUTDIR, and each one's writer
INPUT_WRITERS = {
    "b1": lambda d, ni, nj: write_topog_edge(os.path.join(d, "topog_edge.nc"),
                                             ni, nj, seed=0),
    "obc": lambda d, ni, nj: write_obc_data(d, ni, nj, seed=0),
    "file": lambda d, ni, nj: write_file_inputs(d, ni, nj, seed=0),
    "bgc": lambda d, ni, nj: write_bgc_inputs(d, ni, nj, seed=0)}


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


def build_full(ni: int = 512, nj: int = 512, nk: int = 25, *,
               seed: int | None = None, regridding: bool = True,
               dynamics: str = "rk2", wide_halo_period: int = 2,
               extra: str = "", device="cuda",
               dtype: torch.dtype = torch.float32) -> Model:
    """The full step of bench.py's CONFIG (``configs.BENCH_CONFIG``) with
    BT_WIDE_HALO_PERIOD = 2, at ``ni`` x ``nj`` x ``nk`` with 10 km cells,
    built by ``model.build_model``:

    * reentrant in x, walls in y, flat bottom at 4000 m, f0 = 1e-4,
      beta = 2e-11; layered vertical grid with no interface reduced
      gravity (GINT = 0), Boussinesq, Rho0 = 1035; EQN_OF_STATE = WRIGHT;
    * dt = 600 s, DT_THERM = 1200 s; split RK2 with BE = 0.6, PPM
      continuity, Sadourny energy Coriolis, the 5-point FV pressure
      force with PLM T/S reconstruction (RECONSTRUCT_FOR_PRESSURE, on
      with USE_REGRIDDING), Kv = 1e-4 with the dynamic BBL and quadratic
      drag, biharmonic Smagorinsky viscosity 0.06, BT_cont curves, nstep
      from set_dtbt (27 at 512x512) and the wide-halo march with
      period 2;
    * KD = 1e-5 background diffusivity, KPP, KHTH = 600 GM, MLE, PLM
      tracer advection with 3 pass pairs, KHTR = 600 along-layer
      diffusion, the ideal age tracer;
    * USE_REGRIDDING = True: Z* regridding (ALE_RESOLUTION empty, so
      uniform fractions of the deepest column; MIN_THICKNESS = 1e-3 m)
      and PPM_H4 remapping of tracers and velocities once a thermodynamic
      step, with no diffusive entrainment (ENTRAIN_DIFFUSIVE is off with
      USE_REGRIDDING);
    * WIND_CONFIG = gyres (0.1 Pa), BUOY_CONFIG = linear_restoring with
      FLUXCONST = 0.5 m/day toward SST 25 -> 5 degC south to north;
    * uniform layers of 4000/nk m at rest, TS_CONFIG = linear:
      T = 10 + 12 (0.5 - (k + 0.5)/nk) degC, S = 35 ppt, age = 0.

    ``regridding=False`` gives the layered variant, USE_REGRIDDING =
    False (bench.py's ``ale_regrid_remap`` probe): no ALE, diffusive
    entrainment on and no T/S reconstruction in the pressure force.

    ``dynamics`` picks the text: "rk2" (``BENCH_CONFIG``), "rk2b"
    (``BENCH_CONFIG_RK2B``: SPLIT_RK2B), "unsplit"
    (``BENCH_CONFIG_UNSPLIT``: SPLIT = False, DT = 20 s, DT_THERM =
    120 s, no barotropic parameter), "b1" (``BENCH_CONFIG_B1``: a grid
    of 0.1 degree cells centred on the equator, with the porous-barrier
    file written from seed 0 by ``configs.write_topog_edge`` into
    a temporary directory that the build reads it from) or "nonbouss"
    (``BENCH_CONFIG_NONBOUSS``) or "obc" (``BENCH_CONFIG_OBC``: adiabatic
    and layered, open W and E edges and a strip over the middle half of
    the S edge, the E data written from seed 0 by
    ``configs.write_obc_data`` into a temporary directory; ``regridding``
    does not apply) or "stoch" (``BENCH_CONFIG_STOCH``: GM and the
    column physics with ALE before the dynamics, GME, the Stanley
    correction with STOCH_EOS, SPPT and SKEB) or "b3" (``BENCH_CONFIG_B3``:
    ePBL, kappa-shear and the rest of the third breadth item's column
    physics with Z* ALE) or "b3pp81" (the same with PP81 shear mixing in
    place of kappa-shear) or "bml" (``BENCH_CONFIG_BML``: layered, with
    the bulk mixed layer, LMD94 shear mixing, diffusive entrainment,
    regularization and frazil; ``regridding`` does not apply) or "b4"
    (``BENCH_CONFIG_B4``: MEKE, VarMix, neutral and boundary diffusion,
    the interface filter and the internal tides with Z* ALE) or "b4v"
    (``BENCH_CONFIG_B4V``: the layered text with the Visbeck
    diffusivities, the resolution scaling and the mixed layer's
    epipycnal diffusion; ``regridding`` does not apply) or "hybgen"
    (``BENCH_CONFIG_HYBGEN``: TEOS10, the hybgen coordinate with its
    remap schemes, REGRID_ACCELERATE_INIT) or "adapt"
    (``BENCH_CONFIG_ADAPT``: ROQUET_RHO, the ADAPTIVE coordinate) or
    "unmix" (``BENCH_CONFIG_UNMIX``: ROQUET_SPV, HYCOM1 with hybgen
    unmixing) or "file" (``BENCH_CONFIG_FILE``: the topography, initial
    T/S, sponge, wind, buoyancy fluxes and data_table from the files of
    ``configs.write_file_inputs``, written from seed 0 into a temporary
    directory that is the case directory of the build) or "bgc"
    (``BENCH_CONFIG_BGC``: the MARBL-shaped coupler, the coupled CFCs and
    pseudo-salt, its restoring, river, deposition and sediment files
    written from seed 0 by ``configs.write_bgc_inputs`` into a temporary
    directory) or "shelf" (``BENCH_CONFIG_SHELF``: an ice shelf's
    pressure, stress shielding and melt over the ISOMIP profile) or
    "hurr" (``BENCH_CONFIG_HURR``: a translating hurricane's wind and a
    constant surface heat loss; the storm starts at 0.75 LENLON, 0.5
    LENLAT whatever the width).
    ``wide_halo_period`` sets BT_WIDE_HALO_PERIOD of
    the split texts (1: kernel K3 in place of K3m; open boundaries run K3
    whatever it says).

    ``extra``: more MOM_input lines, read after the text's.

    With ``seed`` None the initial state is the configuration's own (at
    rest and horizontally uniform, as the JAX package builds it).  With
    an integer seed, numpy noise drawn from it is added (h +- 2 m,
    T +- 0.5 degC, u and v +- 0.05 m/s), the same numbers on every
    device, so that runs on two devices can be compared on fields that
    are not roundoff-sized in the first steps.  Runs on ``cuda`` unless
    the caller passes ``device="cpu"``."""
    text = DYNAMICS[dynamics]
    if dynamics != "unsplit":
        text += f"BT_WIDE_HALO_PERIOD = {wide_halo_period}\n"
    text += f"#override NIGLOBAL = {ni}\n#override NJGLOBAL = {nj}\n" \
        f"#override NK = {nk}\n"
    if dynamics == "b1":
        text += (f"#override LENLON = {ni * 0.1!r}\n#override LENLAT = "
                 f"{nj * 0.1!r}\n#override SOUTHLAT = {-nj * 0.05!r}\n")
    else:
        text += (f"#override LENLON = {ni * 10.0}\n"
                 f"#override LENLAT = {nj * 10.0}\n")
    if dynamics == "hurr":
        # the storm starts three quarters of the way east, mid-basin
        text += (f"#override IDL_HURR_X0 = {0.75 * ni * 1e4!r}\n"
                 f"#override IDL_HURR_Y0 = {0.5 * nj * 1e4!r}\n")
    if dynamics == "obc":
        text += obc_strip(ni)
    elif not regridding:
        text += "#override USE_REGRIDDING = False\n"
    with tempfile.TemporaryDirectory() as inputdir:
        if dynamics in INPUT_WRITERS:
            INPUT_WRITERS[dynamics](inputdir, ni, nj)
            text += f"INPUTDIR = {inputdir}\n"
        if dynamics == "file":
            # the data_table is read from the case directory
            path = os.path.join(inputdir, "MOM_input")
            with open(path, "w") as fh:
                fh.write(text + extra)
            pf = ParamFile(path)
        else:
            pf = ParamFile(text=text + extra)
        # USE_PP81 passes the obsolete-parameter guard only without its
        # "Use_PP81" entry (build_model)
        m = build_model(pf, device=device, dtype=dtype,
                        allow_obsolete=("Use_PP81",) if dynamics == "b3pp81"
                        else ())
    if seed is not None:
        d, g = m.domain, m.grid
        rng = np.random.default_rng(seed)

        def noisy(a, scale, mask=None):
            x = a + torch.as_tensor(
                scale * rng.standard_normal(tuple(a.shape)), dtype=dtype,
                device=device)
            return d.fill_halos(x if mask is None else x * mask)

        st = m.state
        m.state = st.replace(h=noisy(st.h, 2.0),
                             T=None if st.T is None else noisy(st.T, 0.5),
                             u=noisy(st.u, 0.05, g.mask2dCu),
                             v=noisy(st.v, 0.05, g.mask2dCv))
        if dynamics in SPLIT_RK2:
            m.split = init_split_state(d, g, m.vgrid, m.state,
                                       horvisc_cfg=m.cfg.split_cfg.horvisc)
        elif dynamics == "rk2b":
            m.split = init_split_b_state(d, g, m.vgrid, m.state)
    return m
