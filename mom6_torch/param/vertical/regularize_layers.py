"""Regularization of near-vanished isopycnal layers (counterpart of
``mom6_tpu.param.vertical.regularize_layers``): a layer thinner than its
deficit target (REG_SFC_DEFICIT; HMIX_MIN for the surface layer when
larger) borrows up to a fraction of the layer below, carrying that
layer's tracer content, in a fixed number of top-down sweeps."""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["RegularizeLayersCfg", "regularize_layers"]

_EPS = 1e-30


@dataclasses.dataclass(frozen=True)
class RegularizeLayersCfg:
    h_def: float = 0.5           # deficit threshold [m]
    donor_frac: float = 0.25     # largest fraction taken from the donor
    n_sweeps: int = 2
    hmix_min: float = 0.0        # HMIX_MIN [m]


def regularize_layers(cfg: RegularizeLayersCfg, h,
                      tracers: dict | None = None):
    """(h, tracers) with the thin layers refilled from below."""
    content = None
    if tracers is not None:
        content = {name: t * h for name, t in tracers.items()}
    target = torch.full((h.shape[0] - 1,) + (1,) * (h.dim() - 1),
                        cfg.h_def, dtype=h.dtype, device=h.device)
    if cfg.hmix_min > cfg.h_def:
        target[0] = cfg.hmix_min
    zero = torch.zeros_like(h[:1])
    for _ in range(cfg.n_sweeps):
        need = torch.clamp(target - h[:-1], min=0.0)
        give = torch.minimum(need, cfg.donor_frac * h[1:])
        gain = torch.cat([give, zero], dim=0)
        loss = torch.cat([zero, give], dim=0)
        if content is not None:
            for name, c in content.items():
                dc = give * (c[1:] / torch.clamp(h[1:], min=_EPS))
                content[name] = (c + torch.cat([dc, zero], dim=0)
                                 - torch.cat([zero, dc], dim=0))
        h = h + gain - loss
    out = None
    if content is not None:
        out = {name: c / torch.clamp(h, min=_EPS)
               for name, c in content.items()}
    return h, out
