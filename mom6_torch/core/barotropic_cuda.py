"""Kernels K3 and K3m, the barotropic subcycle: dispatch and plain
versions.

``subcycle_cuda`` (K3) is the port's counterpart of ``subcycle_pallas``
(mom6_tpu/core/barotropic_pallas.py:345) with ``march=False``: a halo
refresh of width 3 after every substep.  ``subcycle_march_cuda`` (K3m)
is the same call with ``march=True`` (barotropic_pallas.py:232-240,
from barotropic.py:704-721): on arrays widened to a halo of
``3 * period``, ``period`` substeps run with no refresh and the wide
halos are refreshed on each chunk's last substep.  A CUDA tensor runs
the whole subcycle through ``csrc/barotropic.cu`` in one persistent
cooperative launch (one block per SM, each owning a fixed band of
points for every substep, of any length; ``band_plan`` cuts the bands);
a CPU tensor runs ``subcycle_plain`` / ``subcycle_march_plain``, the
``_one``/``block`` loop of mom6_tpu/core/barotropic.py:624-698.  Each
wrapper's ``launches`` grows by one per subcycle and its
``device_launches`` by the device launches that subcycle issued.  See
csrc/barotropic.cu for what bounds the kernels on an H100 and how their
design answers it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from mom6_torch import cuda_build
from mom6_torch.core.barotropic import BT_HALO, find_uhbt
from mom6_torch.parallel.domain import Domain
from mom6_torch.parallel.stencil import ip1, im1, jp1, jm1

__all__ = ["subcycle_cuda", "subcycle_plain", "subcycle_march_cuda",
           "subcycle_march_plain", "SUM_NAMES", "band_plan"]

# constant planes in the kernel's order (csrc/barotropic.cu enum)
CONST_NAMES = ("gtot_E", "gtot_W", "gtot_N", "gtot_S", "q", "Du_q",
               "Dv_q", "Cor_ref_u", "Cor_ref_v", "bt_rem_u", "bt_rem_v",
               "BT_force_u", "BT_force_v", "eta_pf", "IdxCu", "IdyCv",
               "IareaT", "eta_src", "Datu", "Datv")
SUM_NAMES = ("uhbt", "vhbt", "eta", "accel_u", "accel_v", "ubt", "vbt")


def subcycle_plain(eta, ubt, vbt, consts: dict, use_curve: bool,
                   wts: np.ndarray, dtbt: float, bebt: float,
                   domain: Domain):
    """``wts.shape[1]`` forward-backward substeps, u first on even ones,
    with a width-3 halo refresh after each and the seven weighted sums
    (wts rows: vel, eta, trans, accel).  Returns (eta, ubt, vbt, sums)."""
    return _plain_loop(eta, ubt, vbt, consts, use_curve, wts, dtbt, bebt,
                       domain, 1, BT_HALO)


def subcycle_march_plain(eta, ubt, vbt, consts: dict, use_curve: bool,
                         wts: np.ndarray, dtbt: float, bebt: float,
                         domain: Domain, period: int):
    """The wide-halo march: as ``subcycle_plain`` on arrays padded to
    ``domain.halo == 3 * period``, but the whole halo is refreshed only
    after substeps ``period - 1, 2 * period - 1, ...``; the sums of the
    other substeps take the unrefreshed values."""
    _check_march(domain, period, wts)
    return _plain_loop(eta, ubt, vbt, consts, use_curve, wts, dtbt, bebt,
                       domain, period, domain.halo)


def _check_march(domain: Domain, period: int, wts: np.ndarray):
    if period < 2 or period % 2 or domain.halo != 3 * period \
            or wts.shape[1] % period:
        raise ValueError(f"wide-halo march needs an even period >= 2, "
                         f"halo 3*period and whole chunks; got period "
                         f"{period}, halo {domain.halo}, {wts.shape[1]} "
                         f"substeps")


def _plain_loop(eta, ubt, vbt, consts, use_curve, wts, dtbt, bebt,
                domain: Domain, every: int, width: int):
    c = consts
    if use_curve:
        def trans_u(u):
            return find_uhbt(u, *c["cu"]) + c["uhbt0"]

        def trans_v(v):
            return find_uhbt(v, *c["cv"]) + c["vhbt0"]
    else:
        def trans_u(u):
            return c["Datu"] * u

        def trans_v(v):
            return c["Datv"] * v

    def cor_u(vb):
        dvv = c["Dv_q"] * vb
        A = c["q"] * (ip1(dvv) + dvv)
        return A + jm1(A)

    def cor_v(ub):
        duu = c["Du_q"] * ub
        B = c["q"] * (duu + jp1(duu))
        return -(B + im1(B))

    def div(uh, vh):
        return ((uh - im1(uh)) + (vh - jm1(vh))) * c["IareaT"]

    sums = {k: torch.zeros_like(eta) for k in SUM_NAMES}
    for n in range(wts.shape[1]):
        w_v, w_e, w_t, w_a = (float(x) for x in wts[:, n])
        eta_pred = (eta + c["eta_src"]) - dtbt * div(trans_u(ubt),
                                                     trans_v(vbt))
        d_eta = ((1.0 - bebt) * eta + bebt * eta_pred) - c["eta_pf"]
        pf_u = (d_eta * c["gtot_E"] - ip1(d_eta * c["gtot_W"])) \
            * c["IdxCu"]
        pf_v = (d_eta * c["gtot_N"] - jp1(d_eta * c["gtot_S"])) \
            * c["IdyCv"]
        if n % 2 == 0:
            cu = cor_u(vbt) - c["Cor_ref_u"]
            ubt2 = c["bt_rem_u"] * (ubt + dtbt * ((c["BT_force_u"] + cu)
                                                  + pf_u))
            cv = cor_v(ubt2) - c["Cor_ref_v"]
            vbt2 = c["bt_rem_v"] * (vbt + dtbt * ((c["BT_force_v"] + cv)
                                                  + pf_v))
        else:
            cv = cor_v(ubt) - c["Cor_ref_v"]
            vbt2 = c["bt_rem_v"] * (vbt + dtbt * ((c["BT_force_v"] + cv)
                                                  + pf_v))
            cu = cor_u(vbt2) - c["Cor_ref_u"]
            ubt2 = c["bt_rem_u"] * (ubt + dtbt * ((c["BT_force_u"] + cu)
                                                  + pf_u))
        uhbt2 = trans_u(ubt2)
        vhbt2 = trans_v(vbt2)
        eta2 = (eta + c["eta_src"]) - dtbt * div(uhbt2, vhbt2)
        eta, ubt, vbt = eta2, ubt2, vbt2
        if n % every == every - 1:
            eta, ubt, vbt = domain.fill_halos((eta, ubt, vbt), width=width)
        sums = dict(uhbt=sums["uhbt"] + w_t * uhbt2,
                    vhbt=sums["vhbt"] + w_t * vhbt2,
                    eta=sums["eta"] + w_e * eta,
                    accel_u=sums["accel_u"] + w_a * (cu + pf_u),
                    accel_v=sums["accel_v"] + w_a * (cv + pf_v),
                    ubt=sums["ubt"] + w_v * ubt,
                    vbt=sums["vbt"] + w_v * vbt)
    return eta, ubt, vbt, sums


# the launch geometry of csrc/barotropic.cu: THREADS threads a block,
# one block per SM, a band cut into tiles of POINTS_PER_THREAD points a
# thread (a band of one tile keeps its points' state and sums in
# registers for the whole launch)
THREADS, POINTS_PER_THREAD = 768, 3
N_CURVE = 22        # curve and anchor planes; linear transports use 2


class BandPlan(NamedTuple):
    """How one subcycle launch cuts the padded (nj, ni) array: block b
    owns the flat points ``[b * points_per_block, (b + 1) *
    points_per_block)``, in ``tiles`` tiles of THREADS *
    POINTS_PER_THREAD points; ``smem_bytes`` holds their transport
    constants in shared memory, 0 when they do not fit and are read from
    global memory."""
    blocks: int
    points_per_block: int
    tiles: int
    smem_bytes: int

    @property
    def placement(self) -> str:
        return "shared" if self.smem_bytes else "global"


def band_plan(nj: int, ni: int, itemsize: int, curve: bool, sm_count: int,
              smem_limit: int) -> BandPlan:
    """The band plan of a subcycle launch on a card with ``sm_count`` SMs
    and ``smem_limit`` bytes of shared memory a block.  Raises when the
    array's flat indices do not fit the kernel's 32-bit ints."""
    points = nj * ni
    if points > 2**31 - 1:
        raise ValueError(f"barotropic subcycle: {nj}x{ni} points, above "
                         f"the kernel's 32-bit flat indices")
    npb = -(-points // sm_count)
    tiles = -(-npb // (THREADS * POINTS_PER_THREAD))
    smem = (N_CURVE if curve else 2) * npb * itemsize
    return BandPlan(-(-points // npb), npb, tiles,
                    smem if smem <= smem_limit else 0)


def weight_rows(wts: np.ndarray, dtype: torch.dtype, device) -> torch.Tensor:
    """The (4, total) filter weights as the kernel reads them: a
    contiguous tensor in the working type on ``device``, any number of
    substeps.  Kept per weights, dtype and device, so a subcycle with
    weights seen before issues no copy."""
    w = np.ascontiguousarray(wts, dtype=np.float64)
    return _weight_rows(w.tobytes(), w.shape, dtype, torch.device(device))


@functools.lru_cache(maxsize=32)
def _weight_rows(raw: bytes, shape, dtype, device) -> torch.Tensor:
    w = torch.from_numpy(np.frombuffer(raw).reshape(shape).copy())
    if device.type == "cuda":
        w = w.pin_memory()
    # asynchronous on the current stream, ahead of the launch that reads it
    return w.to(device=device, dtype=dtype, non_blocking=True)


@functools.cache
def _lib():
    lib = cuda_build.load("barotropic")
    for t in ("f32", "f64"):
        for name in ("bt_subcycle", "bt_march"):
            fn = getattr(lib, f"{name}_{t}")
            fn.argtypes = ([ctypes.c_void_p] * 3
                           + [ctypes.c_int] * (10 + (name == "bt_march"))
                           + [ctypes.c_double] * 2 + [ctypes.c_int] * 3
                           + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)])
            fn.restype = ctypes.c_int
    lib.bt_device_info.argtypes = [ctypes.c_int] \
        + [ctypes.POINTER(ctypes.c_int)] * 2
    lib.bt_device_info.restype = ctypes.c_int
    lib.bt_error_name.argtypes = [ctypes.c_int]
    lib.bt_error_name.restype = ctypes.c_char_p
    return lib


def _check(rc: int, what: str):
    if rc != 0:
        name = _lib().bt_error_name(rc).decode()
        raise RuntimeError(f"barotropic {what}: CUDA error {rc} ({name})")


@functools.cache
def device_limits(device: int) -> tuple[int, int]:
    """(SM count, opt-in shared memory bytes of a block) of a card."""
    sms, smem = ctypes.c_int(), ctypes.c_int()
    _check(_lib().bt_device_info(device, ctypes.byref(sms),
                                 ctypes.byref(smem)), "device query")
    return sms.value, smem.value


def launch_plan(eta: torch.Tensor, use_curve: bool) -> BandPlan:
    """The band plan of a subcycle on ``eta``'s card."""
    return band_plan(*eta.shape, eta.element_size(), use_curve,
                     *device_limits(eta.device.index))


def subcycle_cuda(eta, ubt, vbt, consts: dict, use_curve: bool,
                  wts: np.ndarray, dtbt: float, bebt: float,
                  domain: Domain):
    """The barotropic subcycle: K3 on CUDA tensors, ``subcycle_plain``
    on CPU tensors.  Same arguments and result as ``subcycle_plain``."""
    if not eta.is_cuda:
        return subcycle_plain(eta, ubt, vbt, consts, use_curve, wts, dtbt,
                              bebt, domain)
    out, n_dev = _launch("bt_subcycle", eta, ubt, vbt, consts, use_curve,
                         wts, dtbt, bebt, domain, BT_HALO, ())
    subcycle_cuda.launches += 1
    subcycle_cuda.device_launches += n_dev
    return out


def subcycle_march_cuda(eta, ubt, vbt, consts: dict, use_curve: bool,
                        wts: np.ndarray, dtbt: float, bebt: float,
                        domain: Domain, period: int):
    """The wide-halo march: K3m on CUDA tensors,
    ``subcycle_march_plain`` on CPU tensors.  Same arguments and result
    as ``subcycle_march_plain``."""
    if not eta.is_cuda:
        return subcycle_march_plain(eta, ubt, vbt, consts, use_curve, wts,
                                    dtbt, bebt, domain, period)
    _check_march(domain, period, wts)
    out, n_dev = _launch("bt_march", eta, ubt, vbt, consts, use_curve, wts,
                         dtbt, bebt, domain, domain.halo, (period,))
    subcycle_march_cuda.launches += 1
    subcycle_march_cuda.device_launches += n_dev
    return out


def _launch(entry, eta, ubt, vbt, consts, use_curve, wts, dtbt, bebt,
            domain, width, extra):
    """One persistent launch; returns (the subcycle's result, the device
    launches issued)."""
    if eta.dtype == torch.float32:
        suffix = "f32"
    elif eta.dtype == torch.float64:
        suffix = "f64"
    else:
        raise NotImplementedError(f"barotropic kernel for {eta.dtype}")
    planes = [consts[k] for k in CONST_NAMES]
    if use_curve:
        planes += list(consts["cu"]) + list(consts["cv"]) \
            + [consts["uhbt0"], consts["vhbt0"]]
    planes = [p.contiguous() for p in planes]
    if any(p.shape != eta.shape or p.dtype != eta.dtype
           or p.device != eta.device for p in planes):
        raise ValueError("subcycle constants must match eta's shape, "
                         "dtype and device")
    const_ptrs = [p.data_ptr() for p in planes]
    const_ptrs += [None] * (len(CONST_NAMES) + N_CURVE - len(const_ptrs))
    wt = weight_rows(wts, eta.dtype, eta.device)
    plan = launch_plan(eta, use_curve)

    nj, ni = eta.shape
    eta_a = eta.contiguous().clone()
    eta_b = torch.empty_like(eta_a)
    ubt_s = ubt.contiguous().clone()
    vbt_s = vbt.contiguous().clone()
    # d_eta and the face transports, two buffers each for u and v
    scratch = torch.empty((5, nj, ni), dtype=eta.dtype, device=eta.device)
    sums = torch.empty((len(SUM_NAMES), nj, ni), dtype=eta.dtype,
                       device=eta.device)
    state = [eta_a, eta_b, ubt_s, vbt_s, *scratch.unbind(0), sums]
    n_dev = ctypes.c_int(0)
    rc = getattr(_lib(), f"{entry}_{suffix}")(
        (ctypes.c_void_p * len(const_ptrs))(*const_ptrs),
        (ctypes.c_void_p * len(state))(*(t.data_ptr() for t in state)),
        wt.data_ptr(), nj, ni, domain.halo, domain.ni, domain.nj, width,
        int(domain.reentrant_x), int(domain.reentrant_y), int(use_curve),
        wt.shape[1], *extra, float(dtbt), float(bebt), plan.blocks,
        plan.points_per_block, plan.smem_bytes,
        torch.cuda.current_stream().cuda_stream, ctypes.byref(n_dev))
    _check(rc, f"{entry}_{suffix} launch")
    eta_f = eta_a if wt.shape[1] % 2 == 0 else eta_b
    return (eta_f, ubt_s, vbt_s, dict(zip(SUM_NAMES, sums.unbind(0)))), \
        n_dev.value


subcycle_cuda.launches = subcycle_cuda.device_launches = 0
subcycle_march_cuda.launches = subcycle_march_cuda.device_launches = 0
