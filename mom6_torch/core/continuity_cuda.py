"""Kernels K1 (continuity sweep) and K2 (BT_cont curve fit): dispatch.

``continuity_ppm_cuda`` and ``set_up_bt_cont_cuda`` are the port's
counterparts of ``continuity_ppm_pallas`` and ``set_up_bt_cont_pallas``
(mom6_tpu/core/continuity_pallas.py:639, :484).  A CUDA tensor goes to
the hand-written kernels of ``csrc/continuity.cu``; a CPU tensor goes
to the plain PyTorch versions in ``continuity_ppm.py``.  On CUDA a
configuration the kernels do not cover raises ``NotImplementedError``.

Each wrapper counts its kernel launches in a plain integer attribute:
``continuity_ppm_cuda.launches`` grows by one per directional sweep
(two per call; a sweep is an edge pass, a flux pass and a divergence
pass), ``set_up_bt_cont_cuda.launches`` by one per call (an edge pass
per direction, then one fit launch for both directions).  See csrc/continuity.cu for what bounds
the kernels on an H100 and how their design answers it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from mom6_torch import cuda_build
from mom6_torch.core.continuity_ppm import (BTContFaces, ContinuityCfg,
                                            ContinuityResult,
                                            continuity_ppm, set_up_bt_cont)
from mom6_torch.core.grid import Grid
from mom6_torch.core.vertical_grid import VerticalGrid

__all__ = ["continuity_ppm_cuda", "set_up_bt_cont_cuda"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double


@functools.cache
def _lib():
    lib = cuda_build.load("continuity")
    for t in ("f32", "f64"):
        sweep = getattr(lib, f"ppm_sweep_{t}")
        sweep.argtypes = [_P] * 15 + [_I] * 5 + [_D] * 3 + [_P]
        sweep.restype = _I
        fit = getattr(lib, f"bt_cont_{t}")
        fit.argtypes = [_P, _I, _I, _I, _D, _D, _D, _P]
        fit.restype = _I
    return lib


def _suffix(dtype: torch.dtype) -> str:
    if dtype == torch.float32:
        return "f32"
    if dtype == torch.float64:
        return "f64"
    raise NotImplementedError(f"continuity kernels for dtype {dtype}")


def _check_cfg(cfg: ContinuityCfg, grid: Grid):
    for name in ("upwind_1st", "simple_2nd", "monotonic", "vol_cfl"):
        if getattr(cfg, name):
            raise NotImplementedError(f"{name} in the CUDA continuity "
                                      "kernels")
    if grid.porous_DavgU is not None or grid.porous_DavgV is not None:
        raise NotImplementedError("porous barriers")


def _prep(ref: torch.Tensor, *tensors):
    """Contiguous views, checked against ``ref``'s device and dtype."""
    out = []
    for t in tensors:
        if t.device != ref.device or t.dtype != ref.dtype:
            raise ValueError(f"tensor on {t.device}/{t.dtype}, expected "
                             f"{ref.device}/{ref.dtype}")
        out.append(t.contiguous())
    return out


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _grid_x(grid: Grid):
    # dlen, Idx, Iarea, face mask, face spacing (du limit), cell mask
    return (grid.dyCu, grid.IdxT, grid.IareaT, grid.mask2dCu, grid.dxCu,
            grid.mask2dT)


def _grid_y(grid: Grid):
    return (grid.dxCv, grid.IdyT, grid.IareaT, grid.mask2dCv, grid.dyCv,
            grid.mask2dT)


def _sweep(grid: Grid, vgrid: VerticalGrid, vel, h, vr, hbt, dt,
           cfg: ContinuityCfg, axis: int):
    """One directional sweep through K1: (h_new, flux, vel_cor)."""
    g = _grid_y(grid) if axis else _grid_x(grid)
    vel, h, vr, hbt, *g = _prep(h, vel, h, vr, hbt, *g)
    nk, nj, ni = h.shape
    if vel.shape != h.shape or vr.shape != h.shape or \
            hbt.shape != h.shape[1:]:
        raise ValueError("continuity sweep: mismatched shapes")
    hm, hp, h_out, flux, vcor = (torch.empty_like(h) for _ in range(5))
    fn = getattr(_lib(), f"ppm_sweep_{_suffix(h.dtype)}")
    rc = fn(_ptr(vel), _ptr(h), _ptr(vr), _ptr(hbt), *map(_ptr, g),
            _ptr(hm), _ptr(hp), _ptr(h_out), _ptr(flux), _ptr(vcor),
            nk, nj, ni, axis, cfg.newton_iters, float(dt),
            float(cfg.cfl_limit), float(vgrid.angstrom), _stream())
    if rc != 0:
        raise RuntimeError(f"continuity sweep kernel failed: CUDA error "
                           f"{rc}")
    continuity_ppm_cuda.launches += 1
    return h_out, flux, vcor


def continuity_ppm_cuda(grid: Grid, vgrid: VerticalGrid, u, v, h, dt,
                        cfg: ContinuityCfg, uhbt, vhbt,
                        visc_rem_u=None, visc_rem_v=None,
                        x_first: bool = True) -> ContinuityResult:
    """Transport-matched PPM continuity (both sweeps).  Output halos are
    not valid; the caller refreshes them, as with the plain version."""
    if not h.is_cuda:
        return continuity_ppm(grid, vgrid, u, v, h, dt, cfg, uhbt=uhbt,
                              vhbt=vhbt, visc_rem_u=visc_rem_u,
                              visc_rem_v=visc_rem_v, x_first=x_first)
    _check_cfg(cfg, grid)
    if uhbt is None or vhbt is None:
        raise NotImplementedError("CUDA continuity without transport "
                                  "matching (uhbt/vhbt)")
    vr_u = visc_rem_u if visc_rem_u is not None else torch.ones_like(u)
    vr_v = visc_rem_v if visc_rem_v is not None else torch.ones_like(v)
    if x_first:
        h1, uh, u_cor = _sweep(grid, vgrid, u, h, vr_u, uhbt, dt, cfg, 0)
        h2, vh, v_cor = _sweep(grid, vgrid, v, h1, vr_v, vhbt, dt, cfg, 1)
    else:
        h1, vh, v_cor = _sweep(grid, vgrid, v, h, vr_v, vhbt, dt, cfg, 1)
        h2, uh, u_cor = _sweep(grid, vgrid, u, h1, vr_u, uhbt, dt, cfg, 0)
    return ContinuityResult(h=h2, uh=uh, vh=vh, u_cor=u_cor, v_cor=v_cor)


continuity_ppm_cuda.launches = 0


def set_up_bt_cont_cuda(grid: Grid, vgrid: VerticalGrid, u, v, h, dt,
                        cfg: ContinuityCfg = ContinuityCfg(),
                        visc_rem_u=None, visc_rem_v=None) -> BTContFaces:
    """Both directions' BT_cont face-area curves (set_up_BT_cont)."""
    if not h.is_cuda:
        return set_up_bt_cont(grid, vgrid, u, v, h, dt, cfg, visc_rem_u,
                              visc_rem_v)
    _check_cfg(cfg, grid)
    vr_u = visc_rem_u if visc_rem_u is not None else torch.ones_like(u)
    vr_v = visc_rem_v if visc_rem_v is not None else torch.ones_like(v)
    gx, gy = _grid_x(grid), _grid_y(grid)
    h, u, v, vr_u, vr_v, *g = _prep(h, h, u, v, vr_u, vr_v, *gx, *gy)
    gx, gy = g[:6], g[6:]
    nk, nj, ni = h.shape
    if not (u.shape == v.shape == vr_u.shape == vr_v.shape == h.shape):
        raise ValueError("BT_cont fit: mismatched shapes")
    scratch = torch.empty((4,) + h.shape, dtype=h.dtype, device=h.device)
    out = torch.empty((12, nj, ni), dtype=h.dtype, device=h.device)
    ptrs = []
    for d, (vel, vr, gd) in enumerate(((u, vr_u, gx), (v, vr_v, gy))):
        dlen, Idx, _, mask_f, dx_face, _ = gd
        ptrs += [vel, vr, dlen, Idx, mask_f, dx_face, scratch[2 * d],
                 scratch[2 * d + 1]] + list(out[6 * d:6 * d + 6])
    ptrs += [h, gx[5]]
    arr = (ctypes.c_void_p * len(ptrs))(*(t.data_ptr() for t in ptrs))
    fn = getattr(_lib(), f"bt_cont_{_suffix(h.dtype)}")
    rc = fn(arr, nk, nj, ni, float(dt), float(cfg.cfl_limit),
            float(vgrid.angstrom), _stream())
    if rc != 0:
        raise RuntimeError(f"BT_cont kernel failed: CUDA error {rc}")
    set_up_bt_cont_cuda.launches += 1
    return BTContFaces(*out.unbind(0))


set_up_bt_cont_cuda.launches = 0
