"""Kernels K1 (continuity sweep) and K2 (BT_cont curve fit): dispatch.

``continuity_ppm_cuda`` and ``set_up_bt_cont_cuda`` are the port's
counterparts of ``continuity_ppm_pallas`` and ``set_up_bt_cont_pallas``
(mom6_tpu/core/continuity_pallas.py:639, :484).  A CUDA tensor goes to
the hand-written kernels of ``csrc/continuity.cu``; a CPU tensor goes
to the plain PyTorch versions in ``continuity_ppm.py``.  The kernels
take every edge scheme of ``ContinuityCfg`` (the default PPM,
upwind_1st, simple_2nd, monotonic) and the volume-based CFL, and K1
sweeps with transport matching (``uhbt``/``vhbt`` given) or without
(both None: one pass at u, as the unsplit and RK2b steppers call it).
On a grid with porous-barrier faces K1 takes each sweep's open
fractions as one more layered input: the wrapper computes them with the
plain ``porous_factor`` from the h entering the sweep (the y sweep's,
with ``x_first``, between the two launches from the h the x launch
wrote) and launches the porous instance.  K2 fits its curves with the
plain face masks on such a grid, as the JAX package does.

Each wrapper counts its kernel launches in a plain integer attribute:
``continuity_ppm_cuda.launches`` grows by one per directional sweep
(two per call; ``continuity_ppm_cuda.untargeted_launches`` and
``porous_launches`` count the untargeted and the porous ones among
them), ``set_up_bt_cont_cuda.launches`` by one
per call (both directions); each is one device kernel.  ``tile_plan`` cuts the array
into the tiles the kernels keep on chip.  See csrc/continuity.cu for
what bounds the kernels on an H100 and how their design answers it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from mom6_torch import cuda_build
from mom6_torch.core.continuity_ppm import (BTContFaces, ContinuityCfg,
                                            ContinuityResult,
                                            continuity_ppm, porous_factor,
                                            set_up_bt_cont)
from mom6_torch.core.grid import Grid
from mom6_torch.core.vertical_grid import VerticalGrid

__all__ = ["continuity_ppm_cuda", "set_up_bt_cont_cuda", "tile_plan",
           "TilePlan"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_long
_D = ctypes.c_double


@functools.cache
def _lib():
    lib = cuda_build.load("continuity")
    for t in ("f32", "f64"):
        sweep = getattr(lib, f"ppm_sweep_{t}")
        sweep.argtypes = [_P] + [_I] * 3 + [_P] + [_D] * 3 + [_P, _L, _P]
        sweep.restype = _I
        fit = getattr(lib, f"bt_cont_{t}")
        fit.argtypes = [_P] + [_I] * 5 + [_D] * 3 + [_P, _L, _P]
        fit.restype = _I
    lib.cont_device_info.argtypes = [_I, ctypes.POINTER(_I),
                                     ctypes.POINTER(_I)]
    lib.cont_device_info.restype = _I
    lib.cont_error_name.argtypes = [_I]
    lib.cont_error_name.restype = ctypes.c_char_p
    return lib


def _check(rc: int, what: str):
    if rc != 0:
        name = _lib().cont_error_name(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({name})")


@functools.cache
def device_limits(device: int) -> tuple[int, int]:
    """(SM count, opt-in shared memory bytes of a block) of a card."""
    sms, smem = _I(), _I()
    _check(_lib().cont_device_info(device, ctypes.byref(sms),
                                   ctypes.byref(smem)), "device query")
    return sms.value, smem.value


# the launch geometry of csrc/continuity.cu: at most MAX_THREADS threads
# a block, one per face column; an SM holds SM_THREADS threads and
# shared memory of a block's opt-in limit plus BLOCK_RESERVED bytes, the
# runtime's share of each block (H100: 232,448 + 1,024 = 228 KB).  The
# plan's cost model, fitted to tiles timed one by one on an H100 (PERF.md):
# the work of a tile is UNITS_COLUMN per face column (six Newton passes
# and the final one, the edge values and the stores, in units of one
# Newton pass) and UNITS_STAGE per staged cell column (the copies, halo
# included); an SM's rate grows with its resident threads.  A block
# alone on its SM overlaps its copies with no other block's work: such
# tiles timed slowest, so they are taken only where nothing else fits.
MAX_THREADS, SM_THREADS, BLOCK_RESERVED = 512, 2048, 1024
UNITS_COLUMN, UNITS_STAGE = 14.5, 5.0
RECORD = 5          # values staged per cell and layer (6 with porous faces)


class TilePlan(NamedTuple):
    """One direction's tiles of a K1 sweep or a K2 call.  A block owns
    ``faces`` faces along the sweep, the first of which only feeds the
    divergence of the next cell (a tile updates ``faces - 1`` cells), by
    ``across`` face columns across it, one thread per face column; it
    stages ``layers`` layers at once, in ``chunks`` chunks (1: the
    whole column stays on chip for every pass), in ``smem_bytes`` of
    shared memory; ``blocks`` tiles cover the array."""
    axis: int
    faces: int
    across: int
    layers: int
    chunks: int
    blocks: int
    smem_bytes: int

    @property
    def threads(self) -> int:
        return self.faces * self.across

    def tile(self) -> tuple[int, int, int, int]:
        """The four ints the kernel takes (csrc/continuity.cu Tile)."""
        return self.faces, self.across, self.layers, self.blocks


def stage_bytes(faces: int, across: int, layers: int, itemsize: int,
                record: int = RECORD) -> int:
    """Shared bytes of a tile: a record of each of its faces+5 cells and
    staged layers (h, its two edge values, u and visc_rem of its face;
    ``record`` 6 adds the face's open fraction), and the cell mask."""
    return itemsize * across * (faces + 5) * (record * layers + 1)


def _shapes(axis: int, threads: int):
    """(faces, across) of the tiles of ``threads`` threads.  The lanes
    run along i: an x tile is rows of 32 or more faces, a y tile 8 to 64
    columns of i (8 fp32 values fill a 32-byte sector; the narrow ones
    let a deep column fit)."""
    if axis == 0:
        return [(f, threads // f) for f in (32, 64, 128) if threads % f == 0]
    return [(threads // q, q) for q in (8, 16, 32, 64)
            if threads % q == 0 and threads // q >= 2]


def _plan(nk, n, m, itemsize, axis, faces, across, smem_limit, record):
    fixed = stage_bytes(faces, across, 0, itemsize, record)
    layers = min(nk, (smem_limit - fixed)
                 // (itemsize * across * (faces + 5) * record))
    if layers < 1:
        return None
    return TilePlan(axis, faces, across, layers, -(-nk // layers),
                    -(-n // (faces - 1)) * -(-m // across),
                    stage_bytes(faces, across, layers, itemsize, record))


def _cost(plans, sm_count: int, smem_limit: int):
    """Sort key of one launch's plans: the fewest chunks, then more than
    one block an SM, then the least modelled time, then the most
    resident threads."""
    threads = plans[0].threads
    smem = max(p.smem_bytes for p in plans)
    per_sm = min(32, SM_THREADS // threads,
                 (smem_limit + BLOCK_RESERVED) // (smem + BLOCK_RESERVED))
    resident = per_sm * threads
    work = sum(p.blocks * p.across * (UNITS_COLUMN * p.faces
                                      + UNITS_STAGE * (p.faces + 5))
               for p in plans)
    return (max(p.chunks for p in plans), per_sm == 1,
            work / (sm_count * resident), -resident)


@functools.cache
def tile_plan(nk: int, nj: int, ni: int, itemsize: int,
              axes: tuple[int, ...], sm_count: int,
              smem_limit: int, porous: bool = False) -> tuple[TilePlan, ...]:
    """The tiles of one launch on a (nk, nj, ni) array of ``itemsize``
    bytes, on a card of ``sm_count`` SMs and ``smem_limit`` bytes of
    shared memory a block: one plan per axis of ``axes`` ((0,) or (1,)
    for a K1 sweep, (0, 1) for K2), all of one block size; ``porous``
    (a K1 sweep with porous faces) stages six values a cell and layer.  A column
    that fits no tile is staged in chunks of layers, so every shape has
    a plan; raises only when not one layer of the smallest tile fits."""
    best = None
    for threads in range(32, MAX_THREADS + 1, 32):
        plans = []
        for axis in axes:
            n, m = (ni, nj) if axis == 0 else (nj, ni)
            cands = [p for f, q in _shapes(axis, threads)
                     if (p := _plan(nk, n, m, itemsize, axis, f, q,
                                    smem_limit, RECORD + porous))
                     is not None]
            if not cands:
                break
            plans.append(min(cands, key=lambda p: _cost((p,), sm_count,
                                                        smem_limit)))
        else:
            key = _cost(plans, sm_count, smem_limit)
            if best is None or key < best[0]:
                best = key, tuple(plans)
    if best is None:
        raise ValueError(f"continuity kernels: not one layer of a tile "
                         f"fits {smem_limit} B of shared memory")
    return best[1]


def launch_plan(h: torch.Tensor, axes: tuple[int, ...],
                porous: bool = False):
    """``tile_plan`` for ``h``'s shape, dtype and card."""
    return tile_plan(*h.shape, h.element_size(), axes,
                     *device_limits(h.device.index), porous)


def _suffix(dtype: torch.dtype) -> str:
    if dtype == torch.float32:
        return "f32"
    if dtype == torch.float64:
        return "f64"
    raise NotImplementedError(f"continuity kernels for dtype {dtype}")


def edge_scheme(cfg: ContinuityCfg) -> int:
    """The kernels' code of ``cfg``'s edge scheme (csrc/ppm.cuh
    EdgeScheme), in the plain version's order of precedence."""
    if cfg.upwind_1st:
        return 1
    if cfg.simple_2nd:
        return 2
    return 3 if cfg.monotonic else 0


def _prep(ref: torch.Tensor, *tensors):
    """Contiguous views, checked against ``ref``'s device and dtype."""
    out = []
    for t in tensors:
        if t.device != ref.device or t.dtype != ref.dtype:
            raise ValueError(f"tensor on {t.device}/{t.dtype}, expected "
                             f"{ref.device}/{ref.dtype}")
        out.append(t.contiguous())
    return out


def _stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _grid_x(grid: Grid):
    # dlen, Idx, Iarea, face mask, face spacing (du limit), cell mask
    return (grid.dyCu, grid.IdxT, grid.IareaT, grid.mask2dCu, grid.dxCu,
            grid.mask2dT)


def _grid_y(grid: Grid):
    return (grid.dxCv, grid.IdyT, grid.IareaT, grid.mask2dCv, grid.dyCv,
            grid.mask2dT)


def _ptrs(tensors):
    """A C array of the tensors' device pointers; None gives NULL."""
    return (_P * len(tensors))(*(None if t is None else t.data_ptr()
                                 for t in tensors))


def _ints(values):
    return (_I * len(values))(*values)


def _sweep(grid: Grid, vgrid: VerticalGrid, vel, h, vr, hbt, dt,
           cfg: ContinuityCfg, axis: int, por=None):
    """One directional sweep through K1: (h_new, flux, vel_cor, dvel),
    transport-matched to ``hbt``; with ``hbt`` None the untargeted sweep
    (``vr`` unused), whose vel_cor and dvel are None.  ``por``: the open
    fractions of the sweep's faces on a porous grid (``porous_factor``
    of the h entering the sweep), which launch the porous instance."""
    targeted = hbt is not None
    g = _grid_y(grid) if axis else _grid_x(grid)
    vel, h, *g = _prep(h, vel, h, *g)
    if targeted:
        vr, hbt = _prep(h, vr, hbt)
    if por is not None:
        por, = _prep(h, por)
    nk, nj, ni = h.shape
    if vel.shape != h.shape or any(p.shape != h.shape[1:] for p in g) \
            or targeted and (vr.shape != h.shape
                             or hbt.shape != h.shape[1:]) \
            or por is not None and por.shape != h.shape:
        raise ValueError("continuity sweep: mismatched shapes")
    plan, = launch_plan(h, (axis,), por is not None)
    h_out, flux = torch.empty_like(h), torch.empty_like(h)
    vcor = dvel = None
    if targeted:
        vcor, dvel = torch.empty_like(h), torch.empty_like(hbt)
    dlen, Idx, iarea, mask_f, dx_face, mask_t = g
    ptrs = [vel, h, vr if targeted else None, hbt, dlen, Idx, iarea,
            mask_f, dx_face if targeted else None, mask_t, h_out, flux,
            vcor, dvel, por]
    opts = (axis, cfg.newton_iters, int(targeted), edge_scheme(cfg),
            int(cfg.vol_cfl))
    fn = getattr(_lib(), f"ppm_sweep_{_suffix(h.dtype)}")
    _check(fn(_ptrs(ptrs), nk, nj, ni, _ints(opts), float(dt),
              float(cfg.cfl_limit), float(vgrid.angstrom),
              _ints(plan.tile()), plan.smem_bytes, _stream()),
           "continuity sweep kernel")
    continuity_ppm_cuda.launches += 1
    if not targeted:
        continuity_ppm_cuda.untargeted_launches += 1
    if por is not None:
        continuity_ppm_cuda.porous_launches += 1
    return h_out, flux, vcor, dvel


def continuity_ppm_cuda(grid: Grid, vgrid: VerticalGrid, u, v, h, dt,
                        cfg: ContinuityCfg, uhbt=None, vhbt=None,
                        visc_rem_u=None, visc_rem_v=None,
                        x_first: bool = True) -> ContinuityResult:
    """PPM continuity (both sweeps), transport-matched to uhbt/vhbt when
    given (then u_cor/v_cor and du_cor/dv_cor are returned too).  Output
    halos are not valid; the caller refreshes them, as with the plain
    version."""
    if not h.is_cuda:
        return continuity_ppm(grid, vgrid, u, v, h, dt, cfg, uhbt=uhbt,
                              vhbt=vhbt, visc_rem_u=visc_rem_u,
                              visc_rem_v=visc_rem_v, x_first=x_first)
    if (uhbt is None) != (vhbt is None):
        raise ValueError("continuity: give both uhbt and vhbt, or neither")
    vr_u = vr_v = None
    if uhbt is not None:
        vr_u = visc_rem_u if visc_rem_u is not None else torch.ones_like(u)
        vr_v = visc_rem_v if visc_rem_v is not None else torch.ones_like(v)
    def sweep(axis, hh):
        vel, vr, hbt = (v, vr_v, vhbt) if axis else (u, vr_u, uhbt)
        return _sweep(grid, vgrid, vel, hh, vr, hbt, dt, cfg, axis,
                      porous_factor(grid, hh, "UV"[axis]))

    if x_first:
        h1, uh, u_cor, du = sweep(0, h)
        h2, vh, v_cor, dv = sweep(1, h1)
    else:
        h1, vh, v_cor, dv = sweep(1, h)
        h2, uh, u_cor, du = sweep(0, h1)
    return ContinuityResult(h=h2, uh=uh, vh=vh, u_cor=u_cor, v_cor=v_cor,
                            du_cor=du, dv_cor=dv)


continuity_ppm_cuda.launches = 0
continuity_ppm_cuda.untargeted_launches = 0
continuity_ppm_cuda.porous_launches = 0


def set_up_bt_cont_cuda(grid: Grid, vgrid: VerticalGrid, u, v, h, dt,
                        cfg: ContinuityCfg = ContinuityCfg(),
                        visc_rem_u=None, visc_rem_v=None) -> BTContFaces:
    """Both directions' BT_cont face-area curves (set_up_BT_cont), with
    the plain face masks on a porous grid too."""
    if not h.is_cuda:
        return set_up_bt_cont(grid, vgrid, u, v, h, dt, cfg, visc_rem_u,
                              visc_rem_v)
    vr_u = visc_rem_u if visc_rem_u is not None else torch.ones_like(u)
    vr_v = visc_rem_v if visc_rem_v is not None else torch.ones_like(v)
    gx, gy = _grid_x(grid), _grid_y(grid)
    h, u, v, vr_u, vr_v, *g = _prep(h, h, u, v, vr_u, vr_v, *gx, *gy)
    gx, gy = g[:6], g[6:]
    nk, nj, ni = h.shape
    if not (u.shape == v.shape == vr_u.shape == vr_v.shape == h.shape) \
            or any(p.shape != h.shape[1:] for p in g):
        raise ValueError("BT_cont fit: mismatched shapes")
    plans = launch_plan(h, (0, 1))
    out = torch.empty((12, nj, ni), dtype=h.dtype, device=h.device)
    ptrs = []
    for d, (vel, vr, gd) in enumerate(((u, vr_u, gx), (v, vr_v, gy))):
        dlen, Idx, _, mask_f, dx_face, _ = gd
        ptrs += [vel, vr, dlen, Idx, mask_f, dx_face] \
            + list(out[6 * d:6 * d + 6])
    ptrs += [h, gx[5], gx[2]]
    fn = getattr(_lib(), f"bt_cont_{_suffix(h.dtype)}")
    _check(fn(_ptrs(ptrs), nk, nj, ni, edge_scheme(cfg), int(cfg.vol_cfl),
              float(dt), float(cfg.cfl_limit),
              float(vgrid.angstrom), _ints(plans[0].tile() + plans[1].tile()),
              max(p.smem_bytes for p in plans), _stream()), "BT_cont kernel")
    set_up_bt_cont_cuda.launches += 1
    return BTContFaces(*out.unbind(0))


set_up_bt_cont_cuda.launches = 0
