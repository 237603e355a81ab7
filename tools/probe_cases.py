"""Which of the shipped cases/ the port builds: for each case directory,
mom6_torch's build_model on the CPU in float64 and then the solo
driver's read_driver_params, on a temporary copy of the case (ref_tc4's
input files made there by its gen_data.py, with the port's NetCDF
writer; tc4 from the repository root, its INPUTDIR).  Prints one line a
case: "builds" when nothing raised and no parameter was left unread
(INPUTDIR aside), else the parameters left unread or the first option
refused as not ported; last, one JSON line.

Usage: python tools/probe_cases.py
"""

import json
import os
import pathlib
import shutil
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def probe(case: str, tmp: str) -> str:
    import torch
    from mom6_torch.drivers.solo import read_driver_params
    from mom6_torch.framework.config import ParamFile
    from mom6_torch.model import build_model
    src = ROOT / "cases" / case
    d = pathlib.Path(tmp) / case
    shutil.copytree(src, d)
    cwd = os.getcwd()
    if case == "ref_tc4":
        import chip_smoke
        chip_smoke.gen_ref_tc4(d)
        os.chdir(d)
    else:
        os.chdir(ROOT)
    try:
        files = [str(d / f) for f in ("MOM_input", "MOM_override")
                 if (d / f).exists()]
        pf = ParamFile(*files)
        m = build_model(pf, device="cpu", dtype=torch.float64)
        read_driver_params(pf, m)
        unused = sorted(set(pf.close(fatal_unused=False)) - {"INPUTDIR"})
    except NotImplementedError as e:
        return f"raises NotImplementedError: {e}"
    finally:
        os.chdir(cwd)
    return "builds" if not unused else "unread: " + ", ".join(unused)


def main():
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for case in sorted(os.listdir(ROOT / "cases")):
            if not (ROOT / "cases" / case / "MOM_input").exists():
                continue
            out[case] = probe(case, tmp)
            print(f"{case}: {out[case]}", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
