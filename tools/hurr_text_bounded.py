"""Whether the JAX package keeps mom6_torch.configs.BENCH_CONFIG_HURR
bounded: the text at 16x16x4 (10 km cells, BT_WIDE_HALO_PERIOD = 2, the
storm's origin moved with the basin to three quarters of LENLON and half
of LENLAT, as entry.build_full moves it) built by mom6_tpu's build_model
and run for 12 steps of its Model.step_fn in float64 on the CPU.  Prints
max |u| and max |v| [m/s], the largest stress [Pa] and the top layer's
temperature range after every step and, last, one JSON line; exits 1 if
a field is not finite or a velocity reaches 1 m/s.  ``--extra`` appends
MOM_input lines to try a variant.

Usage: JAX_PLATFORMS=cpu python tools/hurr_text_bounded.py [--steps 12]
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
    from mom6_tpu.model import build_model

    n, H = args.n, 4
    text = configs.BENCH_CONFIG_HURR + (
        f"BT_WIDE_HALO_PERIOD = 2\n#override NIGLOBAL = {n}\n"
        f"#override NJGLOBAL = {n}\n#override NK = 4\n"
        f"#override LENLON = {n * 10.0}\n#override LENLAT = {n * 10.0}\n"
        f"#override IDL_HURR_X0 = {0.75 * n * 1e4!r}\n"
        f"#override IDL_HURR_Y0 = {0.5 * n * 1e4!r}\n"
        + args.extra.replace("\\n", "\n") + "\n")
    m = build_model(ParamFile(text=text))
    step = m.step_fn()
    s, sp, tr = m.state, m.split_state, m.tracers
    finite = True
    taumax = 0.0
    for k in range(args.steps):
        fc = m.forces_fn(jax.numpy.asarray((k + 0.5) * m.dt))
        taumax = max(taumax, float(np.abs(np.asarray(fc.taux)).max()),
                     float(np.abs(np.asarray(fc.tauy)).max()))
        s, sp, tr = step(s, sp, tr, k)
        umax = float(np.abs(np.asarray(s.u)).max())
        vmax = float(np.abs(np.asarray(s.v)).max())
        t_top = np.asarray(s.T[0])[H:-H, H:-H]
        finite = finite and all(
            bool(np.isfinite(np.asarray(getattr(s, f))).all())
            for f in ("u", "v", "h", "T", "S"))
        print(f"step {k + 1}: max|u| {umax!r} max|v| {vmax!r} max|tau| "
              f"{taumax!r} top T [{t_top.min()!r}, {t_top.max()!r}]")
    ok = finite and umax < 1.0 and vmax < 1.0
    print(json.dumps({"text": "BENCH_CONFIG_HURR", "extra": args.extra,
                      "shape": [4, n, n], "steps": args.steps,
                      "max_abs_u": umax, "max_abs_v": vmax,
                      "max_abs_tau": taumax, "finite": finite,
                      "bounded": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
