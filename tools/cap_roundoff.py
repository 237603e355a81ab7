"""Where the NUOPC-shaped cap's card-against-CPU difference sits.

One coupling interval of ``mom6_torch.drivers.nuopc_cap.MOM6Cap``
(chip_smoke.py's ``cap_interval``: 2 steps over its cap text at 32x32x6
in float64, under its seeded import fields) in four variants: from rest
or from ``entry.build_full``'s seeded perturbation, each with the
import's Sa_pslv (101325 Pa plus 100 Pa of noise in each cell) or with a
uniform 101325 Pa.  For each variant and each of u, v, the sea level and
the two exported slopes it prints the field's largest magnitude, and
the largest absolute difference, its (k, j, i) on the padded grid and
the relative difference, between

* ``ulp``: two CPU runs whose initial h differs by one ulp in every
  cell (how far the interval carries a roundoff of the state), and
* ``card``: the card and the CPU (not with ``--cpu``).

Usage: python tools/cap_roundoff.py [--cpu]
"""

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="only the ulp comparison, on the CPU")
    args = ap.parse_args(argv)
    import torch
    import chip_smoke as cs
    torch.set_num_threads(1)
    card = not args.cpu
    if card and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --cpu")
    report = {}
    for seeded in (False, True):
        for noise in (True, False):
            label = (f"{'seeded' if seeded else 'rest'}, Sa_pslv "
                     f"{'noise' if noise else 'uniform'}")
            base = cs.cap_interval("cpu", seeded, pslv_noise=noise)
            pairs = {"ulp": cs.cap_interval("cpu", seeded, nudge=True,
                                            pslv_noise=noise)}
            if card:
                pairs["card"] = cs.cap_interval("cuda", seeded,
                                                pslv_noise=noise)
            report[label] = {}
            for name, other in pairs.items():
                res = report[label][name] = {}
                for k in base:
                    scale, err, at = cs.abs_err_at(base[k], other[k])
                    res[k] = {"max_abs": scale, "abs_err": err, "at": at,
                              "rel_err": err / scale}
                    print(f"{label:24s} {name:4s} {k:9s} max|x| {scale:.4e}"
                          f" abs err {err:.3e} at {at} rel "
                          f"{err / scale:.3e}", flush=True)
    print(json.dumps(report))


if __name__ == "__main__":
    main()
