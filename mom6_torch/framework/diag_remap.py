"""Vertical remapping of diagnostics onto fixed output coordinates.

Counterpart of ``mom6_tpu.framework.diag_remap`` (MOM_diag_remap): a
layer diagnostic is remapped conservatively onto a fixed Z* output grid
(the ``_z`` diagnostic coordinate) whose cells are the z-cell extents
clipped by the local bathymetry, with vanished cells set to the fill
value; ``build_rho_thickness`` gives the layers of target potential
densities (the ``_rho`` coordinate); ``reintegrate_to_z`` re-bins an
extensive diagnostic keeping each column total, and
``interpolate_to_z`` interpolates an interface diagnostic to fixed
depths.  All of it is plain PyTorch on the fields' device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mom6_torch.ale.regridding import RegridCfg, build_grid
from mom6_torch.ale.remapping import RemapCfg, remap_column_means

__all__ = ["DiagRemapCfg", "build_z_thickness", "remap_to_z",
           "build_rho_thickness", "reintegrate_to_z", "interpolate_to_z"]


@dataclasses.dataclass(frozen=True)
class DiagRemapCfg:
    """Fixed z output levels (interface depths, increasing, [m])."""
    z_edges: tuple = ()
    remap: RemapCfg = RemapCfg(scheme="PPM_H4")

    @staticmethod
    def uniform(nz: int, max_depth: float,
                scheme: str = "PPM_H4") -> "DiagRemapCfg":
        return DiagRemapCfg(
            z_edges=tuple(np.linspace(0.0, max_depth, nz + 1)),
            remap=RemapCfg(scheme=scheme))


def build_z_thickness(cfg: DiagRemapCfg, bathy: torch.Tensor):
    """(nz, ...) thicknesses of the output z cells clipped by the bottom:
    max(min(e[k+1], D) - min(e[k], D), 0)."""
    e = torch.as_tensor(np.asarray(cfg.z_edges, np.float64),
                        dtype=bathy.dtype, device=bathy.device)
    e = e.reshape((-1,) + (1,) * bathy.ndim)
    ecap = torch.minimum(e, bathy[None])
    return torch.clamp(ecap[1:] - ecap[:-1], min=0.0)


def build_rho_thickness(rho_targets, h, bathy, T, S, eos,
                        rho0: float = 1035.0, g: float = 9.8):
    """Per-column thicknesses of the target potential-density layers: the
    RHO regrid inversion of each column's profile."""
    rl = torch.as_tensor(rho_targets, dtype=h.dtype, device=h.device)
    return build_grid(RegridCfg(mode="RHO", min_thickness=0.0), h, bathy,
                      T, S, eos, rlay=rl, rho0=rho0, g=g)


def remap_to_z(field, h, h_z, cfg: DiagRemapCfg,
               fill_value: float = float("nan")):
    """A (nk, ...) layer diagnostic remapped onto the (nz, ...) output
    cells (intensive cell means); cells with no water get
    ``fill_value``."""
    out = remap_column_means(h, field, h_z + 1e-30, cfg.remap)
    return torch.where(h_z > 0.0, out, torch.full_like(out, fill_value))


def _locate(z_src, z, nk: int, dtype):
    """The source layer index of each depth in ``z`` (clipped)."""
    below = (z_src[:-1, None] <= z[None]).to(dtype)
    return torch.clamp(torch.sum(below, dim=0) - 1, 0, nk - 1).to(
        torch.int64)


def reintegrate_to_z(field, h, h_z, fill_value: float = 0.0):
    """An extensive layer diagnostic (a layer integral) re-binned onto the
    output cells with each column total kept: the piecewise-constant
    density field/h integrated over each target cell."""
    z0 = torch.zeros_like(h[:1])
    z_src = torch.cat([z0, torch.cumsum(h, dim=0)], dim=0)
    z_dst = torch.cat([torch.zeros_like(h_z[:1]),
                       torch.cumsum(h_z, dim=0)], dim=0)
    dens = field / (h + 1e-30)
    Isrc = torch.cat([torch.zeros_like(field[:1]),
                      torch.cumsum(field, dim=0)], dim=0)
    k = _locate(z_src, z_dst, h.shape[0], field.dtype)
    z_lo = torch.gather(z_src, 0, k)
    d_k = torch.gather(dens, 0, k)
    I_lo = torch.gather(Isrc, 0, k)
    z_cl = torch.minimum(torch.clamp(z_dst, min=0.0), z_src[-1:])
    I_dst = I_lo + d_k * (z_cl - z_lo)
    out = I_dst[1:] - I_dst[:-1]
    return torch.where(h_z > 0.0, out, torch.full_like(out, fill_value))


def interpolate_to_z(field_int, h, z_out,
                     fill_value: float = float("nan")):
    """An interface diagnostic (nk+1, ...) interpolated linearly to the
    fixed output depths ``z_out``."""
    z_src = torch.cat([torch.zeros_like(h[:1]), torch.cumsum(h, dim=0)],
                      dim=0)
    zo = torch.as_tensor(np.asarray(z_out, np.float64), dtype=h.dtype,
                         device=h.device).reshape((-1,) + (1,) * (h.ndim - 1))
    zo_b = zo.expand((zo.shape[0],) + tuple(h.shape[1:]))
    k = _locate(z_src, zo_b, h.shape[0], field_int.dtype)
    z_lo = torch.gather(z_src, 0, k)
    z_hi = torch.gather(z_src, 0, k + 1)
    f_lo = torch.gather(field_int, 0, k)
    f_hi = torch.gather(field_int, 0, k + 1)
    w = torch.clamp((zo_b - z_lo) / torch.clamp(z_hi - z_lo, min=1e-30),
                    0.0, 1.0)
    out = (1.0 - w) * f_lo + w * f_hi
    return torch.where(zo_b <= z_src[-1:], out,
                       torch.full_like(out, fill_value))
