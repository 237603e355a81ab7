"""Hypsometric depth list for the APE column of ocean.stats.

Counterpart of ``mom6_tpu.diagnostics.depth_list``: an ordered list of
bottom depths with, at each depth, the open cross-sectional area and the
ocean volume below.  ``stat_sums`` uses it to find the resting height
of every interface (the depth at which the fluid below that interface
would sit if levelled over the real hypsometry) and from that the
available potential energy.

The list is built once on the host (a numpy sort of the bathymetry) and
then lives on the grid's device as three 1D float64 tensors.  With
READ_DEPTH_LIST ``depth_list_setup`` reads the list from a file when the
file's checksum of the bathymetry (a bit count, ``depth_chksum``)
matches the grid's, and otherwise computes the list and writes the file.
"""

from __future__ import annotations

from typing import NamedTuple

import os

import numpy as np
import torch

from mom6_torch.framework.error_handler import WARNING, MOM_error
from mom6_torch.framework.io import read_attrs, read_field, write_fields

__all__ = ["DepthList", "create_depth_list", "depth_list_setup",
           "write_depth_list"]


class DepthList(NamedTuple):
    """Sorted deepest-first: ``depth[0]`` is the deepest point and
    ``vol_below`` grows along the list (vol_below[i] = ocean volume
    strictly below depth[i]; area[i] = open area at depth[i])."""
    depth: torch.Tensor
    area: torch.Tensor
    vol_below: torch.Tensor


def create_depth_list(domain, grid, min_depth_inc: float = 0.0
                      ) -> DepthList:
    """Build the list from the model bathymetry; ``min_depth_inc`` culls
    entries closer in depth than this increment (D_LIST_MIN_INC)."""
    def host(a):
        return domain.interior(a).detach().cpu().double().numpy().ravel()

    D = host(grid.bathyT)
    A = host(grid.areaT * grid.mask2dT)
    order = np.argsort(-D, kind="stable")     # deepest first
    Ds, As = D[order], A[order]

    depths, areas, vols = [], [], []
    vol = 0.0
    area = 0.0
    d_prev = Ds[0]
    d_listed = Ds[0]
    n = Ds.size
    for k in range(n):
        vol += area * (d_prev - Ds[k])
        area += As[k]
        if not depths or k == n - 1 \
                or (k + 1 < n and Ds[k + 1] < d_listed - min_depth_inc):
            depths.append(Ds[k])
            areas.append(area)
            vols.append(vol)
            if k + 1 < n:
                d_listed = Ds[k + 1]
        d_prev = Ds[k]
    # sentinel entry: an effectively infinite volume so that interface
    # searches always bracket
    depths.append(depths[-1])
    areas.append(areas[-1])
    vols.append(vols[-1] * 1000.0 + 1.0)
    dev = grid.bathyT.device

    def dev_t(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float64,
                               device=dev)

    return DepthList(depth=dev_t(depths), area=dev_t(areas),
                     vol_below=dev_t(vols))


def _grid_chksum(domain, grid) -> int:
    """The number of set bits of the compute domain's bathymetry in
    float64: the tag that ties a depth-list file to its topography."""
    d = np.ascontiguousarray(domain.interior(grid.bathyT).detach().to(
        "cpu", torch.float64).numpy())
    return int(np.unpackbits(np.frombuffer(d.tobytes(),
                                           dtype=np.uint8)).sum())


def write_depth_list(path: str, dl: DepthList, domain, grid) -> None:
    """The list to a NetCDF-3 file, tagged with the bathymetry's
    checksum."""
    write_fields(path, {k: getattr(dl, k).cpu().numpy()
                        for k in ("depth", "area", "vol_below")},
                 dims={k: ("list",) for k in ("depth", "area", "vol_below")},
                 global_attrs={"depth_chksum": _grid_chksum(domain, grid)})


def depth_list_setup(domain, grid, *, read_file: bool = False,
                     path: str = "Depth_list.nc", min_depth_inc: float = 0.0
                     ) -> DepthList:
    """The depth list of the model bathymetry.  With ``read_file``
    (READ_DEPTH_LIST): the list of ``path`` when its checksum matches
    the bathymetry, else (with a warning) the computed list, which is
    then written to ``path``."""
    if read_file and os.path.exists(path):
        try:
            stored = int(read_attrs(path).get("depth_chksum", -1))
            now = _grid_chksum(domain, grid)
            if stored == now:
                dev = grid.bathyT.device
                return DepthList(*(torch.as_tensor(
                    np.asarray(read_field(path, k), np.float64),
                    device=dev) for k in ("depth", "area", "vol_below")))
            MOM_error(WARNING, f"Depth list file {path} checksum {stored} "
                      f"does not match topography {now}; regenerating")
        except (OSError, ValueError, KeyError, TypeError):
            pass
    dl = create_depth_list(domain, grid, min_depth_inc)
    if read_file:
        try:
            write_depth_list(path, dl, domain, grid)
        except OSError:
            pass
    return dl
