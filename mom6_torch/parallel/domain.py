"""Single-device horizontal domain and halo fills.

Counterpart of ``mom6_tpu.parallel.domain.Domain`` on one device: all
fields are halo-padded ``(..., njh, nih)`` tensors, x is the last axis
and y the one before it.  ``fill_halos`` fills the halo rings from the
array's own opposite edge (reentrant) or with zeros (solid wall), x
first, then y with strips spanning the freshly filled x halos, so
corners follow the JAX package exactly.

Multi-device decomposition (the ``shard_map``/``ppermute`` exchange)
and the tripolar fold are not ported yet; a ``Domain`` asking for
either raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["Domain", "tree_map"]


def tree_map(fn, tree):
    """Apply ``fn`` to every tensor leaf of a nest of tuples, lists and
    dicts; ``None`` leaves pass through."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    raise TypeError(f"unsupported halo-fill leaf {type(tree).__name__}")


@dataclasses.dataclass(frozen=True)
class Domain:
    ni: int                      # global compute points, x
    nj: int                      # global compute points, y
    halo: int = 4
    layout: tuple[int, int] = (1, 1)
    reentrant_x: bool = False
    reentrant_y: bool = False
    tripolar_n: bool = False

    def __post_init__(self):
        if tuple(self.layout) != (1, 1):
            raise NotImplementedError(
                f"domain layout {self.layout}: multi-device decomposition")
        if self.tripolar_n:
            raise NotImplementedError("tripolar_n: tripolar fold")

    @property
    def nih(self) -> int:
        return self.ni + 2 * self.halo

    @property
    def njh(self) -> int:
        return self.nj + 2 * self.halo

    def interior(self, f):
        """Strip halos: the (..., nj, ni) compute tile."""
        H = self.halo
        return f[..., H:H + self.nj, H:H + self.ni]

    def pad(self, f):
        """Zero-pad a (..., nj, ni) tile out to the halo-padded view."""
        H = self.halo
        return torch.nn.functional.pad(f, (H, H, H, H))

    def fill_halos(self, f, width: int | None = None):
        """Halo rings refreshed to ``width`` (default: the full halo)
        on a tensor or a nest of tensors; returns new tensors."""
        w = self.halo if width is None else width
        if w == 0:
            return f
        if w > self.halo:
            raise ValueError(f"halo width {w} exceeds allocated halo "
                             f"{self.halo}")
        return tree_map(lambda a: self._fill(a, w), f)

    def fill_vector_halos(self, u, v, width: int | None = None):
        """C-grid vector pair; without a tripolar fold this is a plain
        fill of each component."""
        return self.fill_halos(u, width), self.fill_halos(v, width)

    def fill_halos_group(self, fields, width: int | None = None):
        """One call for a whole nest of fields; on one device it fills
        each leaf in turn (the JAX package stacks leaves only to fuse
        the multi-device exchange)."""
        return self.fill_halos(fields, width)

    def _fill(self, f, w: int):
        H, ni, nj = self.halo, self.ni, self.nj
        if self.reentrant_x:
            f = torch.cat([f[..., :, :H - w], f[..., :, H + ni - w:H + ni],
                           f[..., :, H:H + ni], f[..., :, H:H + w],
                           f[..., :, H + ni + w:]], dim=-1)
        else:
            f = f.clone()
            f[..., :, H - w:H] = 0
            f[..., :, H + ni:H + ni + w] = 0
        if self.reentrant_y:
            f = torch.cat([f[..., :H - w, :], f[..., H + nj - w:H + nj, :],
                           f[..., H:H + nj, :], f[..., H:H + w, :],
                           f[..., H + nj + w:, :]], dim=-2)
        else:
            f[..., H - w:H, :] = 0
            f[..., H + nj:H + nj + w, :] = 0
        return f
