"""Whether the JAX package keeps mom6_torch.configs.BENCH_CONFIG_BGC
bounded: the text at 16x16x4 (inputs from configs.write_bgc_inputs,
seed 0) built by mom6_tpu's build_model and run for 12 steps of its
Model.step_fn in float64 on the CPU.  Prints max |u| and max |v| [m/s]
and the smallest BGC tracer value after every step and, last, one JSON
line; exits 1 if a field is not finite or a BGC tracer is negative.

Usage: JAX_PLATFORMS=cpu python tools/bgc_text_bounded.py [--steps 12]
"""

import argparse
import json
import pathlib
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--n", type=int, default=16)
    args = ap.parse_args(argv)

    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    jax.config.update("jax_disable_most_optimizations", True)
    import numpy as np
    from mom6_torch import configs
    from mom6_tpu.framework.config import ParamFile
    from mom6_tpu.model import build_model

    n = args.n
    with tempfile.TemporaryDirectory() as d:
        configs.write_bgc_inputs(d, n, n, seed=0)
        path = pathlib.Path(d) / "MOM_input"
        path.write_text(configs.BENCH_CONFIG_BGC + (
            f"BT_WIDE_HALO_PERIOD = 2\n#override NIGLOBAL = {n}\n"
            f"#override NJGLOBAL = {n}\n#override NK = 4\n"
            f"#override LENLON = {n * 10.0}\n"
            f"#override LENLAT = {n * 10.0}\nINPUTDIR = {d}\n"))
        m = build_model(ParamFile(str(path)))
        bgc = list(m.ocean_cfg.bgc._specs)
        step = m.step_fn()
        s, sp, tr = m.state, m.split_state, m.tracers
        finite, tr_min = True, 0.0
        for k in range(args.steps):
            s, sp, tr = step(s, sp, tr, k)
            umax = float(np.abs(np.asarray(s.u)).max())
            vmax = float(np.abs(np.asarray(s.v)).max())
            tr_min = min(float(np.asarray(tr[b]).min()) for b in bgc)
            finite = finite and all(
                bool(np.isfinite(np.asarray(f)).all())
                for f in [getattr(s, f) for f in ("u", "v", "h", "T", "S")]
                + list(tr.values()))
            print(f"step {k + 1}: max|u| {umax!r} max|v| {vmax!r} "
                  f"min BGC tracer {tr_min!r}")
    ok = finite and tr_min >= 0.0
    print(json.dumps({"text": "BENCH_CONFIG_BGC", "shape": [4, n, n],
                      "steps": args.steps, "tracers": sorted(tr),
                      "max_abs_u": umax, "max_abs_v": vmax,
                      "min_bgc_tracer": tr_min, "finite": finite}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
