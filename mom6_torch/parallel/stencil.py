"""Shift helpers for C-grid stencils on halo-padded tensors.

``ip1(f)[j, i] == f[j, i+1]`` etc.  A shift is a ``torch.roll`` on the
trailing axes, so values that wrap across the array edge land in halo
zones that ``Domain.fill_halos`` refreshes before the next stencil
phase (the same convention as ``mom6_tpu.parallel.stencil``).
"""

import torch

__all__ = ["ip1", "im1", "jp1", "jm1", "ishift", "jshift"]


def ip1(f):
    return torch.roll(f, -1, dims=-1)


def im1(f):
    return torch.roll(f, 1, dims=-1)


def jp1(f):
    return torch.roll(f, -1, dims=-2)


def jm1(f):
    return torch.roll(f, 1, dims=-2)


def ishift(f, n):
    return torch.roll(f, -n, dims=-1)


def jshift(f, n):
    return torch.roll(f, -n, dims=-2)
