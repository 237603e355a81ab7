"""Truncation-point column dumps (counterpart of
``mom6_tpu.diagnostics.point_accel``): when the velocity limiter
truncates, the driver appends the prognostic column (u, v, h, T, S)
at the largest |u| + |v| point to U_TRUNC_FILE."""

from __future__ import annotations

import numpy as np

__all__ = ["dump_worst_column"]


def dump_worst_column(path: str, domain, grid, state, step: int,
                      label: str = "") -> str:
    """Append the column at the current |u|max point to ``path``;
    returns the block written."""
    ui = domain.interior(state.u).detach().cpu().numpy()
    vi = domain.interior(state.v).detach().cpu().numpy()
    sp = np.abs(ui) + np.abs(vi)
    k, j, i = np.unravel_index(np.argmax(sp), sp.shape)
    jj, ii = j + domain.halo, i + domain.halo
    names = ("u", "v", "h") + (("T", "S") if state.T is not None else ())
    lines = [f"# step {step} {label}: worst column at "
             f"(i={i}, j={j}, k={k}), depth "
             f"{float(grid.bathyT[jj, ii]):.1f} m, "
             f"|u|max={sp[k, j, i]:.4e} m/s"]
    for name in names:
        col = getattr(state, name)[:, jj, ii].detach().cpu().numpy()
        lines.append(f"{name}: " + " ".join(f"{x: .6e}" for x in col))
    block = "\n".join(lines) + "\n"
    with open(path, "a") as f:
        f.write(block)
    return block
