"""Global energy/mass statistics: the ``ocean.stats`` table.

Counterpart of ``mom6_tpu.diagnostics.sum_output``: order-invariant
global sums (``framework/efp.py``) of kinetic and potential energy,
mass, mean sea level, salt and heat, and the maximum CFL number,
written in the JAX package's fixed-format table, plus the energy-blowup
abort.  ``stat_sums`` runs on the state's device and returns limbs and
scalars; ``collect_stats`` turns them into floats on the host.

The fields are widened to float64 before any product is taken, so a
float32 run's sums are the exact sums of its float64-widened integrands
(the JAX package sums a float32 run with its int32 limb path instead).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from mom6_torch.core.grid import Grid
from mom6_torch.core.pressure_force import interface_heights
from mom6_torch.core.state import State
from mom6_torch.core.vertical_grid import VerticalGrid
from mom6_torch.framework.efp import (efp_limbs_to_float_ingraph, efp_sum,
                                      efp_sum_layers, efp_to_float)
from mom6_torch.framework.error_handler import (FatalError, MOM_error,
                                                WARNING)
from mom6_torch.parallel.domain import Domain
from mom6_torch.parallel.stencil import im1, jm1

__all__ = ["Stats", "stat_sums", "collect_stats", "format_stats_header",
           "format_stats_line", "EnergyBlowupError"]


class EnergyBlowupError(FatalError):
    pass


@dataclasses.dataclass
class Stats:
    step: int
    day: float
    truncs: int
    energy_per_mass: float      # [m2 s-2]
    max_cfl: float
    mean_sea_level: float       # [m]
    total_mass: float           # [kg]
    mean_salin: float
    mean_temp: float
    # resting depth of the top interface [m] with the depth list, else
    # None
    h0: Optional[float] = None


def stat_sums(domain: Domain, grid: Grid, vgrid: VerticalGrid,
              state: State, dt: float, depth_list=None) -> dict:
    """Limb sums and the max CFL on the state's device; host-side
    assembly happens in ``collect_stats``."""
    f64 = torch.float64
    h, u, v = (state.h.to(f64), state.u.to(f64), state.v.to(f64))
    bathyT = grid.bathyT.to(f64)
    areaT = grid.areaT.to(f64) * grid.mask2dT.to(f64)
    interior = domain.interior

    vol_w = interior(h * areaT)

    # KE: 0.5 h areaT (u² + v²) with face → center averaging
    u2c = 0.5 * (u * u + im1(u * u))
    v2c = 0.5 * (v * v + jm1(v * v))
    ke_density = 0.5 * h * areaT * (u2c + v2c)

    # PE: sum over interfaces of 0.5 g'_K areaT e_K² (absolute datum);
    # the bottom interface is fixed and contributes no energy
    e = interface_heights(vgrid, h, bathyT)
    gp = vgrid.g_prime[:h.shape[0]].to(f64).reshape(-1, 1, 1)
    pe_density = 0.5 * gp * (e[:-1] * e[:-1] - bathyT[None] ** 2) * areaT

    out = {
        "vol": efp_sum(vol_w),
        "area": efp_sum(interior(areaT)),
        "ke": efp_sum(interior(ke_density)),
        "pe": efp_sum(interior(pe_density)),
        "eta": efp_sum(interior(e[0] * areaT)),
    }

    if depth_list is not None:
        # APE against the depth-list hypsometry: the per-layer global
        # volumes come from limb sums, so the resting depths z0 are as
        # order-invariant as the sums
        vol_lay = efp_limbs_to_float_ingraph(efp_sum_layers(vol_w))
        volbelow = torch.flip(torch.cumsum(torch.flip(vol_lay, [0]), 0),
                              [0])                     # below iface K
        nl = depth_list.vol_below.shape[0]
        li = torch.clamp(torch.searchsorted(depth_list.vol_below, volbelow,
                                            right=True) - 1, 0, nl - 2)
        z0 = depth_list.depth[li] - (volbelow - depth_list.vol_below[li]) \
            / depth_list.area[li]                       # positive down
        z0b = z0.reshape(-1, 1, 1)
        hint = z0b + e[:-1]
        hbot = torch.clamp(z0b - bathyT[None], min=0.0)
        ape_density = 0.5 * gp * (hint * hint - hbot * hbot) * areaT
        out["ape"] = efp_sum(interior(ape_density))
        out["h0"] = z0[0]
    if state.T is not None:
        T, S = state.T.to(f64), state.S.to(f64)
        out["heat"] = efp_sum(interior(T * h * areaT))
        out["salt"] = efp_sum(interior(S * h * areaT))

    cfl_u = torch.abs(u) * dt * grid.IdxCu.to(f64)
    cfl_v = torch.abs(v) * dt * grid.IdyCv.to(f64)
    out["max_cfl"] = torch.maximum(torch.max(interior(cfl_u)),
                                   torch.max(interior(cfl_v)))
    return out


def collect_stats(raw: dict, vgrid: VerticalGrid, step: int, day: float,
                  truncs: int = 0, energy_cap: float = 1.0e6) -> Stats:
    """Host side: limbs → floats → Stats; raises on energy blowup."""
    vol = efp_to_float(raw["vol"])
    area = efp_to_float(raw["area"])
    ke = efp_to_float(raw["ke"])
    # with the depth list the energy column uses the available PE
    # relative to the levelled-over-hypsometry state, otherwise the
    # absolute-datum PE
    pe = efp_to_float(raw["ape"] if "ape" in raw else raw["pe"])
    eta = efp_to_float(raw["eta"])
    mass = vgrid.Rho0 * vol
    epm = (ke + pe) / max(mass / vgrid.Rho0, 1e-300)
    if not math.isfinite(epm) or abs(epm) > energy_cap:
        msg = (f"Energy per mass {epm:.6e} m2 s-2 exceeds cap "
               f"{energy_cap:g} at step {step} — model blowup detected")
        MOM_error(WARNING, msg)
        raise EnergyBlowupError(msg)
    heat = efp_to_float(raw["heat"]) / max(vol, 1e-300) \
        if "heat" in raw else 0.0
    salt = efp_to_float(raw["salt"]) / max(vol, 1e-300) \
        if "salt" in raw else 0.0
    return Stats(step=step, day=day, truncs=truncs,
                 energy_per_mass=epm,
                 max_cfl=float(raw["max_cfl"]),
                 mean_sea_level=eta / max(area, 1e-300),
                 total_mass=mass, mean_salin=salt, mean_temp=heat,
                 h0=float(raw["h0"]) if "h0" in raw else None)


def format_stats_header() -> str:
    """The two header lines of ocean.stats."""
    return ("  Step,       Day,  Truncs,      Energy/Mass,      Maximum CFL,"
            "  Mean Sea Level,  Total Mass,  Mean Salin, Mean Temp, "
            "Frac Mass Err, Salin Err, Temp Err\n"
            "            [days]                 [m2 s-2]           [Nondim]"
            "       [m]             [kg]         [PSU]     [degC]"
            "       [Nondim]      [PSU]     [degC]\n")


def format_stats_line(s: Stats, mass0: float | None = None) -> str:
    mass_err = 0.0 if not mass0 else (s.total_mass - mass0) / mass0
    return (f"{s.step:6d},{s.day:11.3f},{s.truncs:8d},"
            f" En {s.energy_per_mass:.10E}, CFL {s.max_cfl:8.5f},"
            f" SL {s.mean_sea_level: .4E}, M {s.total_mass:.6E},"
            f" S {s.mean_salin:8.4f}, T {s.mean_temp:8.4f},"
            f" Me {mass_err: .2E}\n")
