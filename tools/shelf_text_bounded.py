"""Whether the JAX package keeps mom6_torch.configs.BENCH_CONFIG_SHELF
bounded: the text at 16x16x4 (10 km cells, BT_WIDE_HALO_PERIOD = 2)
built by mom6_tpu's build_model and run for 12 steps of its
Model.step_fn in float64 on the CPU.  Prints max |u| and max |v| [m/s],
the top layer's temperature range under the shelf and the melt's range
[kg m-2 s-1] after every step and, last, one JSON line; exits 1 if a
field is not finite or a velocity reaches 1 m/s.  ``--extra`` appends
MOM_input lines to try a variant (e.g. "#override REENTRANT_X =
True": the channel reentrant again, the shelf against the seam).

Usage: JAX_PLATFORMS=cpu python tools/shelf_text_bounded.py [--steps 12]
       [--extra LINES]
"""

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--n", type=int, default=16)
    ap.add_argument("--extra", default="")
    args = ap.parse_args(argv)

    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    jax.config.update("jax_disable_most_optimizations", True)
    import numpy as np
    from mom6_torch import configs
    from mom6_tpu.framework.config import ParamFile
    from mom6_tpu.ice_shelf.shelf_main import shelf_fluxes
    from mom6_tpu.model import build_model

    n, H = args.n, 4
    text = configs.BENCH_CONFIG_SHELF + (
        f"BT_WIDE_HALO_PERIOD = 2\n#override NIGLOBAL = {n}\n"
        f"#override NJGLOBAL = {n}\n#override NK = 4\n"
        f"#override LENLON = {n * 10.0}\n#override LENLAT = {n * 10.0}\n"
        + args.extra.replace("\\n", "\n") + "\n")
    m = build_model(ParamFile(text=text))
    sc, ss = m.shelf_cfg, m.ice_shelf
    under = np.asarray(ss.mask(sc.min_thickness))[H:-H, H:-H] > 0
    step = m.step_fn()
    s, sp, tr = m.state, m.split_state, m.tracers
    finite = True
    for k in range(args.steps):
        s, sp, tr = step(s, sp, tr, k)
        umax = float(np.abs(np.asarray(s.u)).max())
        vmax = float(np.abs(np.asarray(s.v)).max())
        t_top = np.asarray(s.T[0])[H:-H, H:-H][under]
        melt = np.asarray(shelf_fluxes(sc, ss, s.T[0], s.S[0])[2])[
            H:-H, H:-H][under]
        finite = finite and all(
            bool(np.isfinite(np.asarray(getattr(s, f))).all())
            for f in ("u", "v", "h", "T", "S"))
        print(f"step {k + 1}: max|u| {umax!r} max|v| {vmax!r} top T under "
              f"the shelf [{t_top.min()!r}, {t_top.max()!r}] melt "
              f"[{melt.min()!r}, {melt.max()!r}]")
    ok = finite and umax < 1.0 and vmax < 1.0
    print(json.dumps({"text": "BENCH_CONFIG_SHELF", "extra": args.extra,
                      "shape": [4, n, n], "steps": args.steps,
                      "max_abs_u": umax, "max_abs_v": vmax,
                      "finite": finite, "bounded": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
