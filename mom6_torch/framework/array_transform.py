"""Quarter-turn index rotation of C-grid fields.

Counterpart of ``mom6_tpu.framework.array_transform``: one
counterclockwise quarter turn (old +x becomes new +y) of halo-padded
fields, with the one-position shifts of the staggered points, the
harness that holds a rotated run to the rotated solution.
"""

from __future__ import annotations

import torch

__all__ = ["rotate_scalar", "rotate_vector", "rotate_corner"]


def rotate_scalar(a):
    """A cell-centred (..., nj, ni) field turned: (..., ni, nj), with
    new[j', i'] = old[nj - 1 - i', j']."""
    return torch.flip(torch.swapaxes(a, -1, -2), dims=(-2,))


def rotate_corner(q):
    """A corner field turned: the scalar map, then a -1 roll along the
    new j' axis."""
    return torch.roll(rotate_scalar(q), -1, dims=-2)


def rotate_vector(u, v):
    """(u, v) at east and north faces turned: the old v becomes the new
    u, and minus the old u, rolled by -1 along the new j' axis, the new
    v."""
    u_new = rotate_scalar(v)
    v_new = -torch.roll(rotate_scalar(u), -1, dims=-2)
    return u_new, v_new
