"""Debugging aids: state checksums and the halo redundancy check.

Counterpart of ``mom6_tpu.diagnostics.debugging`` (MOM_state_chksum and
MOM_debugging's check_redundant): ``state_chksum`` bundles the
checksums of the prognostic fields, and ``check_halo_consistency``
counts the halo points of a field that differ from the interior points
they copy.  The port runs one ``Domain`` (layout 1x1), so the blocked
array of the JAX package's check is the padded field itself.
"""

from __future__ import annotations

import numpy as np

from mom6_torch.framework.checksums import Chksum, chksum
from mom6_torch.parallel.domain import Domain

__all__ = ["state_chksum", "check_halo_consistency"]


def state_chksum(domain: Domain, state, label: str = "") -> dict[str, Chksum]:
    """{name: Chksum} of u, v, h, T and S (those present); printed one
    line each under ``label`` when given."""
    out = {}
    for name in ("u", "v", "h", "T", "S"):
        f = getattr(state, name, None)
        if f is not None:
            out[name] = chksum(domain, f)
    if label:
        for k, v in out.items():
            print(f"{label} {k}: {v}")
    return out


def check_halo_consistency(domain: Domain, field, reentrant_wrap: bool = True,
                           atol: float = 0.0) -> int:
    """The number of halo points of the padded ``field`` (a tensor or an
    array, (..., njh, nih)) whose values differ by more than ``atol``
    from the interior points they copy; with ``reentrant_wrap`` False
    the points outside the global domain are not checked."""
    H, nj, ni = domain.halo, domain.nj, domain.ni
    x = field.detach().cpu().numpy() if hasattr(field, "detach") \
        else np.asarray(field)
    interior = x[..., H:H + nj, H:H + ni]
    bad = 0
    for jj in range(nj + 2 * H):
        for ii in range(ni + 2 * H):
            gj, gi = jj - H, ii - H
            if reentrant_wrap:
                gj %= nj
                gi %= ni
            elif not (0 <= gj < nj and 0 <= gi < ni):
                continue
            if not np.allclose(x[..., jj, ii], interior[..., gj, gi],
                               atol=atol, rtol=0):
                bad += 1
    return bad
