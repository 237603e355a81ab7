"""Kernels K3 and K3m, the barotropic subcycle: dispatch and plain
versions.

``subcycle_cuda`` (K3) is the port's counterpart of ``subcycle_pallas``
(mom6_tpu/core/barotropic_pallas.py:345) with ``march=False``: a halo
refresh of width 3 after every substep.  ``subcycle_march_cuda`` (K3m)
is the same call with ``march=True`` (barotropic_pallas.py:232-240,
from barotropic.py:704-721): on arrays widened to a halo of
``3 * period``, ``period`` substeps run with no refresh and the wide
halos are refreshed on each chunk's last substep.  A CUDA tensor runs
the whole subcycle through ``csrc/barotropic.cu`` (four launches per
substep, issued by one host loop in C); a CPU tensor runs
``subcycle_plain`` / ``subcycle_march_plain``, the ``_one``/``block``
loop of mom6_tpu/core/barotropic.py:624-698.  Each wrapper's
``launches`` grows by one per subcycle.  See csrc/barotropic.cu for
what bounds the kernels on an H100 and how their design answers it.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from mom6_torch import cuda_build
from mom6_torch.core.barotropic import BT_HALO, find_uhbt
from mom6_torch.parallel.domain import Domain
from mom6_torch.parallel.stencil import ip1, im1, jp1, jm1

__all__ = ["subcycle_cuda", "subcycle_plain", "subcycle_march_cuda",
           "subcycle_march_plain", "SUM_NAMES"]

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


@functools.cache
def _lib():
    lib = cuda_build.load("barotropic")
    for t in ("f32", "f64"):
        for name in ("bt_subcycle", "bt_march"):
            fn = getattr(lib, f"{name}_{t}")
            fn.argtypes = ([ctypes.c_void_p] * 3
                           + [ctypes.c_int] * (10 + (name == "bt_march"))
                           + [ctypes.c_double] * 2 + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
    return lib


def subcycle_cuda(eta, ubt, vbt, consts: dict, use_curve: bool,
                  wts: np.ndarray, dtbt: float, bebt: float,
                  domain: Domain):
    """The barotropic subcycle: K3 on CUDA tensors, ``subcycle_plain``
    on CPU tensors.  Same arguments and result as ``subcycle_plain``."""
    if not eta.is_cuda:
        return subcycle_plain(eta, ubt, vbt, consts, use_curve, wts, dtbt,
                              bebt, domain)
    out = _launch("bt_subcycle", eta, ubt, vbt, consts, use_curve, wts,
                  dtbt, bebt, domain, BT_HALO, ())
    subcycle_cuda.launches += 1
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
    out = _launch("bt_march", eta, ubt, vbt, consts, use_curve, wts, dtbt,
                  bebt, domain, domain.halo, (period,))
    subcycle_march_cuda.launches += 1
    return out


def _launch(entry, eta, ubt, vbt, consts, use_curve, wts, dtbt, bebt,
            domain, width, extra):
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
    const_ptrs += [None] * (42 - len(const_ptrs))

    nj, ni = eta.shape
    eta_a = eta.contiguous().clone()
    eta_b = torch.empty_like(eta_a)
    ubt_s = ubt.contiguous().clone()
    vbt_s = vbt.contiguous().clone()
    scratch = torch.empty((3, nj, ni), dtype=eta.dtype, device=eta.device)
    sums = torch.zeros((len(SUM_NAMES), nj, ni), dtype=eta.dtype,
                       device=eta.device)
    total = wts.shape[1]
    wt = torch.as_tensor(np.ascontiguousarray(wts), dtype=eta.dtype,
                         device=eta.device)
    state = [eta_a, eta_b, ubt_s, vbt_s, scratch[0], scratch[1],
             scratch[2], sums]
    rc = getattr(_lib(), f"{entry}_{suffix}")(
        (ctypes.c_void_p * 42)(*const_ptrs),
        (ctypes.c_void_p * 8)(*(t.data_ptr() for t in state)),
        wt.data_ptr(), nj, ni, domain.halo, domain.ni, domain.nj, width,
        int(domain.reentrant_x), int(domain.reentrant_y), int(use_curve),
        total, *extra, float(dtbt), float(bebt),
        torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"barotropic {entry} kernel failed: CUDA error "
                           f"{rc}")
    eta_f = eta_a if total % 2 == 0 else eta_b
    return eta_f, ubt_s, vbt_s, dict(zip(SUM_NAMES, sums.unbind(0)))


subcycle_cuda.launches = 0
subcycle_march_cuda.launches = 0
