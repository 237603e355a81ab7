"""Sponges: restoring toward reference profiles.

Counterpart of ``mom6_tpu.param.vertical.sponge`` (MOM6's MOM_ALE_sponge
and the layered MOM_sponge): Newtonian relaxation of T/S toward
reference profiles with a spatially varying inverse damping time,
applied implicitly, a' = a + dt g / (1 + dt g) (a_ref - a).  With a
reference grid of its own (``ref_h``, any number of layers) the profiles
are first remapped onto the model's current thicknesses (the ALE
sponge).  In layered runs interface heights are restored instead
(``apply_eta_sponge``).
"""

from __future__ import annotations

import torch

from mom6_torch.ale.remapping import RemapCfg, remap_column_means

__all__ = ["apply_sponge", "apply_eta_sponge"]

# the ALE sponge remaps its targets with PLM, as MOM_ALE_sponge does
_REMAP = RemapCfg(scheme="PLM")


def apply_sponge(state_fields: dict, h, iresttime, dt, ref_fields: dict,
                 ref_h=None) -> dict:
    """``state_fields`` damped toward ``ref_fields`` (a field without a
    reference is returned as it is).  ``iresttime`` (njh, nih) is the
    inverse restoring time [s-1], 0 where there is no sponge; with
    ``ref_h`` (nk_ref, njh, nih) the references are remapped onto ``h``
    first."""
    damp = dt * iresttime
    fac = damp / (1.0 + damp)
    out = {}
    for name, a in state_fields.items():
        ref = ref_fields.get(name)
        if ref is None:
            out[name] = a
            continue
        if ref_h is not None:
            ref = remap_column_means(ref_h, ref, h, _REMAP)
        out[name] = a + fac[None] * (ref - a)
    return out


def apply_eta_sponge(h, iresttime, dt, d_ref, angstrom: float = 0.0):
    """Layered interface-height restoring: the interior interface depths
    (below the surface, positive down) are damped implicitly toward
    ``d_ref`` (nk + 1, njh, nih) and made monotonic again, with the
    surface and the bottom pinned so that each column keeps its total;
    returns the new thicknesses (at least ``angstrom``)."""
    nk = h.shape[0]
    d = torch.cat([torch.zeros_like(h[:1]), torch.cumsum(h, dim=0)], dim=0)
    htot = d[-1]
    fac = (dt * iresttime) / (1.0 + dt * iresttime)
    d_tgt = torch.minimum(torch.clamp(d_ref, min=0.0), htot[None])
    d_new = d + fac[None] * (d_tgt - d)
    K = torch.arange(nk + 1, device=h.device).reshape(
        (-1,) + (1,) * (h.ndim - 1))
    d_new = torch.where(K == 0, torch.zeros_like(d_new),
                        torch.where(K == nk, htot[None], d_new))
    d_new = torch.cummax(d_new, dim=0).values
    d_new = torch.minimum(d_new, htot[None])
    d_new = torch.where(K == nk, htot[None], d_new)
    return torch.clamp(d_new[1:] - d_new[:-1], min=angstrom)
