"""Deterministic gridded random numbers.

Counterpart of ``mom6_tpu.framework.random``: per-cell random fields
that do not depend on the layout, because each cell's stream is keyed
on its global (i, j) index.  The JAX package folds the index mix
``gi * 2654435761 ^ gj * 40503`` (uint32) into ``jax.random.key(seed)``
and draws ``nk`` values a cell with its threefry2x32 generator; this
module computes the same bits with a counter-based threefry2x32 of its
own, in plain PyTorch:

* the key of a seed is the pair (high, low) of its 64-bit two's
  complement;
* ``fold_in(key, m)`` hashes the counter pair (0, m) under the key;
* draw i of a cell hashes the counter pair (0, i) under the cell's key
  (the partitionable counter layout): 64-bit values take the two hashed
  words as high and low half, 32-bit values their exclusive or; a draw
  of a whole shape from one key (``uniform``, ``normal``: the ensemble's
  perturbations) hashes each value's flat index, split into its high
  and low words;
* ``uniform`` keeps the top mantissa bits under the exponent of 1.0 and
  subtracts 1; ``normal`` is sqrt(2) erfinv(u) with u uniform on
  (nextafter(-1, 0), 1), erfinv by the polynomials that XLA evaluates
  (Giles, "Approximating the erfinv function": three ranges of
  w = -log1p(-u^2) in float64, two in float32).

The uint32 arithmetic runs in ``torch.int64`` with explicit masks, so
that it gives the same bits on the CPU and on CUDA.  The draws take the
dtype of the caller (the model's): float64 takes 64 bits a value,
float32 32 bits, as the JAX generator does in each precision.  The
uniform fields equal the JAX package's bit for bit; the normal ones
differ from its in the last bits (log1p and the rounding of the
polynomials).
"""

from __future__ import annotations

import numpy as np
import torch

from mom6_torch.parallel.domain import Domain

__all__ = ["gridded_normal", "gridded_uniform", "key", "fold_in",
           "uniform", "normal"]

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _mul32(a, b: int):
    """(a * b) mod 2**32 for a in [0, 2**32) without int64 overflow."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k0, k1, x0, x1):
    """The threefry2x32 hash (20 rounds) of the counter words (x0, x1)
    under the key words (k0, k1); every argument an int64 tensor or int
    holding a uint32 value, broadcast together.  Returns the two hashed
    words."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for block in range(5):
        for r in _ROTATIONS[block % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(block + 1) % 3]) & _MASK
        x1 = (x1 + ks[(block + 2) % 3] + block + 1) & _MASK
    return x0, x1


# erfinv: Horner coefficients, highest power first, of each range of w
_ERFINV64 = (
    (6.25, 3.125, False, (
        -3.6444120640178196996e-21, -1.685059138182016589e-19,
        1.2858480715256400167e-18, 1.115787767802518096e-17,
        -1.333171662854620906e-16, 2.0972767875968561637e-17,
        6.6376381343583238325e-15, -4.0545662729752068639e-14,
        -8.1519341976054721522e-14, 2.6335093153082322977e-12,
        -1.2975133253453532498e-11, -5.4154120542946279317e-11,
        1.051212273321532285e-09, -4.1126339803469836976e-09,
        -2.9070369957882005086e-08, 4.2347877827932403518e-07,
        -1.3654692000834678645e-06, -1.3882523362786468719e-05,
        0.0001867342080340571352, -0.00074070253416626697512,
        -0.0060336708714301490533, 0.24015818242558961693,
        1.6536545626831027356)),
    (16.0, 3.25, True, (
        2.2137376921775787049e-09, 9.0756561938885390979e-08,
        -2.7517406297064545428e-07, 1.8239629214389227755e-08,
        1.5027403968909827627e-06, -4.013867526981545969e-06,
        2.9234449089955446044e-06, 1.2475304481671778723e-05,
        -4.7318229009055733981e-05, 6.8284851459573175448e-05,
        2.4031110387097893999e-05, -0.0003550375203628474796,
        0.00095328937973738049703, -0.0016882755560235047313,
        0.0024914420961078508066, -0.0037512085075692412107,
        0.005370914553590063617, 1.0052589676941592334,
        3.0838856104922207635)),
    (None, 5.0, True, (
        -2.7109920616438573243e-11, -2.5556418169965252055e-10,
        1.5076572693500548083e-09, -3.7894654401267369937e-09,
        7.6157012080783393804e-09, -1.4960026627149240478e-08,
        2.9147953450901080826e-08, -6.7711997758452339498e-08,
        2.2900482228026654717e-07, -9.9298272942317002539e-07,
        4.5260625972231537039e-06, -1.9681778105531670567e-05,
        7.5995277030017761139e-05, -0.00021503011930044477347,
        -0.00013871931833623122026, 1.0103004648645343977,
        4.8499064014085844221)))
_ERFINV32 = (
    (5.0, 2.5, False, (
        2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
        0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
        1.50140941)),
    (None, 3.0, True, (
        -0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
        0.00573950773, -0.0076224613, 0.00943887047, 1.00167406,
        2.83297682)))


def erfinv(x):
    """erfinv on (-1, 1) by the range polynomials XLA evaluates, the
    last range first so that each lower range overwrites it; +-inf at
    +-1."""
    w = -torch.log1p(-x * x)
    sqrt_w = torch.sqrt(w)
    out = None
    for limit, shift, use_sqrt, coefs in reversed(
            _ERFINV64 if x.dtype == torch.float64 else _ERFINV32):
        t = (sqrt_w if use_sqrt else w) - shift
        p = torch.full_like(x, coefs[0])
        for c in coefs[1:]:
            p = c + p * t
        out = p if out is None else torch.where(w < limit, p, out)
    return torch.where(x.abs() == 1.0, x * torch.finfo(x.dtype).max,
                       out * x)


def _seed_key(seed: int):
    seed = int(seed)
    return (seed >> 32) & _MASK, seed & _MASK


def key(seed: int) -> tuple:
    """The key of ``seed`` (``jax.random.key(seed)``): two uint32 words
    as Python ints."""
    return _seed_key(seed)


def fold_in(k: tuple, m: int) -> tuple:
    """``jax.random.fold_in(k, m)``: the counter pair (0, m) hashed
    under the key."""
    return tuple(int(w) for w in threefry2x32(k[0], k[1], 0, int(m) & _MASK))


def _shape_bits(k: tuple, shape, dtype, device):
    """Floats in [1, 2) of a whole ``shape`` drawn from one key: the
    counter of each value is its flat index, split into its high and low
    32-bit words (the partitionable layout)."""
    n = int(np.prod(shape, dtype=np.int64))
    i = torch.arange(n, dtype=torch.int64, device=device).reshape(shape)
    b0, b1 = threefry2x32(k[0], k[1], i >> 32, i & _MASK)
    return _float_bits(b0, b1, dtype)


def _float_bits(b0, b1, dtype):
    if dtype == torch.float64:
        # the 64-bit word (b0 << 32 | b1) shifted right by 12
        bits = (b0 << 20) | (b1 >> 12) | 0x3FF0000000000000
        return bits.view(torch.float64)
    if dtype == torch.float32:
        bits = ((b0 ^ b1) >> 9) | 0x3F800000
        return bits.to(torch.int32).view(torch.float32)
    raise ValueError(f"random values in {dtype}: float32 or float64 only")


def uniform(k: tuple, shape=(), *, dtype: torch.dtype = torch.float64,
            device="cpu"):
    """``jax.random.uniform(k, shape, dtype)``: values in [0, 1)."""
    return _shape_bits(k, tuple(shape), dtype, device) - 1.0


def normal(k: tuple, shape=(), *, dtype: torch.dtype = torch.float64,
           device="cpu"):
    """``jax.random.normal(k, shape, dtype)``: standard normal values,
    sqrt(2) erfinv of uniforms on (nextafter(-1, 0), 1)."""
    return _normal_from(_shape_bits(k, tuple(shape), dtype, device) - 1.0,
                        dtype)


def _normal_from(u, dtype):
    npt = np.float64 if dtype == torch.float64 else np.float32
    lo = np.nextafter(npt(-1.0), npt(0.0))
    span = npt(1.0) - lo
    u = torch.clamp(u * float(span) + float(lo), min=float(lo))
    return erfinv(u) * float(npt(np.sqrt(2.0)))


def _cell_keys(domain: Domain, seed: int, i0: int, j0: int, device):
    """(njh, nih) key words of every cell from its global index."""
    H = domain.halo
    ii = torch.arange(domain.nih, dtype=torch.int64, device=device) - H + i0
    jj = torch.arange(domain.njh, dtype=torch.int64, device=device) - H + j0
    gi = (ii & _MASK)[None, :]
    gj = (jj & _MASK)[:, None]
    mix = _mul32(gi, 2654435761) ^ _mul32(gj, 40503)
    k0, k1 = _seed_key(seed)
    return threefry2x32(k0, k1, torch.zeros_like(mix), mix)


def _uniform_bits(domain, seed, nk, i0, j0, dtype, device):
    """(nk, njh, nih) floats in [1, 2) from the top mantissa bits."""
    c0, c1 = _cell_keys(domain, seed, i0, j0, device)
    i = torch.arange(nk, dtype=torch.int64, device=device).reshape(-1, 1, 1)
    b0, b1 = threefry2x32(c0[None], c1[None], torch.zeros_like(i), i)
    return _float_bits(b0, b1, dtype)


def gridded_uniform(domain: Domain, seed: int, nk: int = 1, i0: int = 0,
                    j0: int = 0, *, dtype: torch.dtype = torch.float64,
                    device="cpu"):
    """(nk, njh, nih) uniform values in [0, 1), layout-invariant.
    i0/j0: the global origin of the compute domain."""
    return _uniform_bits(domain, seed, nk, i0, j0, dtype, device) - 1.0


def gridded_normal(domain: Domain, seed: int, nk: int = 1, i0: int = 0,
                   j0: int = 0, *, dtype: torch.dtype = torch.float64,
                   device="cpu"):
    """(nk, njh, nih) standard normal values, layout-invariant."""
    return _normal_from(
        _uniform_bits(domain, seed, nk, i0, j0, dtype, device) - 1.0, dtype)
