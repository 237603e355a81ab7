"""The reference's own spread on the default SSA solve: the JAX
package's ``ssa_velocity_solve`` (24 Picard refreshes of 200 CG
iterations) on the ISOMIP cavity of tests/test_isomip_shelf.py (48x8
cells of 10 km, the ISOMIP bed from 540 to 900 m, ice tapering from 800
m at the west wall to 200 m at 55 % of the channel, Weertman drag
C_BASAL_FRICTION 1e10 over the grounded cells), jitted against the same
call under ``jax.disable_jit()``, in float64 on the CPU.  Prints the
largest difference of u, v and the viscosity relative to each field's
largest value, then one JSON line.  tests/test_torch_ice_shelf.py holds
the port's default solve to ten times this spread.  The eager run takes
~10 minutes.

Usage: JAX_PLATFORMS=cpu python tools/ssa_spread.py [--n-outer 24]
       [--n-inner 200]
"""

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

NI, NJ, H = 48, 8, 4
LENLON, LENLAT, MAX_DEPTH = 480.0, 80.0, 900.0


def isomip_case():
    """(domain, grid, h, mask) of the JAX package on the ISOMIP cavity."""
    import numpy as np
    import jax.numpy as jnp
    from mom6_tpu.core.grid import cartesian_grid
    from mom6_tpu.parallel.domain import Domain
    from mom6_tpu.user.configs import topo_isomip
    d = Domain(ni=NI, nj=NJ, halo=H)
    ctx = {"max_depth": MAX_DEPTH, "west": 0.0, "lenlon": LENLON}
    g = cartesian_grid(
        d, lenlon_km=LENLON, lenlat_km=LENLAT, f0=-1.4e-4, beta=0.0,
        depth_fn=lambda lo, la: topo_isomip(np.asarray(lo), np.asarray(la),
                                            ctx),
        max_depth=MAX_DEPTH)
    lon = np.asarray(g.geoLonT)
    xn = np.clip((lon - lon.min()) / LENLON, 0.0, 1.0)
    h = np.where(xn < 0.55, 800.0 + (200.0 - 800.0) * xn / 0.55, 0.0) \
        * np.asarray(g.mask2dT)
    h = d.fill_halos(jnp.asarray(h))
    return d, g, h, (h > 1e-3).astype(h.dtype)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-outer", type=int, default=24)
    ap.add_argument("--n-inner", type=int, default=200)
    args = ap.parse_args(argv)
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import numpy as np
    from mom6_tpu.ice_shelf.dynamics import SSACfg, ssa_velocity_solve
    from mom6_tpu.ice_shelf.shelf_main import (ShelfCfg, ShelfState,
                                               update_grounding)
    d, g, h, mask = isomip_case()
    cfg = SSACfg(n_outer=args.n_outer, n_inner=args.n_inner, c_basal=1e10)
    _, gf = update_grounding(ShelfCfg(ssa=cfg),
                             ShelfState(h_shelf=h, bed_elev=g.bathyT))

    def solve(hh, mm, gg):
        return ssa_velocity_solve(cfg, g, hh, mm, ground_frac=gg,
                                  bed_elev=g.bathyT)

    t0 = time.perf_counter()
    jit = jax.jit(solve)(h, mask, gf)
    t1 = time.perf_counter()
    with jax.disable_jit():
        eager = solve(h, mask, gf)
    t2 = time.perf_counter()
    spread = {}
    for name, a, b in zip(("u", "v", "visc"), jit, eager):
        a, b = np.asarray(a), np.asarray(b)
        spread[name] = float(np.abs(a - b).max() / np.abs(a).max())
        print(f"{name}: jitted against eager, max |diff| / max |{name}| "
              f"{spread[name]!r}")
    print(json.dumps({"case": "isomip 48x8, c_basal 1e10",
                      "n_outer": args.n_outer, "n_inner": args.n_inner,
                      "spread": spread, "jit_s": t1 - t0,
                      "eager_s": t2 - t1}))


if __name__ == "__main__":
    main()
