"""Staged bring-up of K1 and K7 at every head dim (the rungs 64, 128, 192 and
256 of csrc/paged_attention.cu, csrc/flash_fwd.cu and K7's f32 kernel in
csrc/flash_f32.cu) on one H100, before the whole chip_smoke.py.

    python3 head_dims_bringup.py [--stages build,quick,timed,serve] [--out DIR]

`build` compiles the K1 and K7 libraries alone (paged_attention in its four
variants, flash_fwd in its two, flash_f32) and prints the `paged_build` and
`wide_build` lines (registers, spill bytes and SASS counts of every
instantiation); `quick` runs chip_smoke.py's untimed head-dim cases
(`check_head_dims`: every width of HEAD_DIMS on every K1 route and dtype
pair and on K7, the options at d = 96 and 256, and the resident blocks of
the decode and f32 kernels at every rung) and prints the failed checks;
`timed` times the rows at d = 96 and 256 (`head_dim_rows`); `serve` builds
every source and serves Phi-3-mini widths (`serve_phi3`: the reference
check, then the chunked and bucketed paths). Exits 1 when a check failed.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import chip_smoke as cs  # noqa: E402
from xf_flash_attention_cutlass_tpu_torch import _build  # noqa: E402

K1_K7_SOURCES = ("paged_attention", "paged_attention_f16", "paged_attention_wide",
                 "paged_attention_f16_wide", "flash_fwd", "flash_fwd_wide", "flash_f32")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--stages", default="build,quick")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("head_dims_bringup.py: no CUDA device")
    stages = args.stages.split(",")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    checks, paths, report, cases = cs.Checks(), {}, {}, []
    report["smi"] = cs.nvidia_smi()
    t0 = time.perf_counter()
    if "serve" not in stages:
        _build.SOURCES = K1_K7_SOURCES
    libs = _build.build_all()
    report["build_s"] = time.perf_counter() - t0
    print(json.dumps({"build_s": report["build_s"], "smi": report["smi"]}), flush=True)
    report["paged_build"] = cs.paged_build_report(checks, libs)
    report["wide_build"] = cs.wide_build_report(checks, libs)
    report["flash_f32_build"] = cs.flash_f32_build_report(checks)
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases += checks.cases
    for name in ("quick", "timed", "serve"):
        if name not in stages:
            continue
        checks, t0 = cs.Checks(), time.perf_counter()  # each stage fails on its own checks
        try:
            if name == "quick":
                cs.head_dims_phase(gen, None, checks, quick=True)
            elif name == "timed":
                report["head_dim_kernels"] = cs.head_dim_rows(gen, cs.Timer(), checks)
                print(json.dumps({"head_dim_kernels": report["head_dim_kernels"]}), flush=True)
            else:
                report["serve_phi3"] = cs.serve_phi3(gen, checks, paths, 0)
        except RuntimeError as e:
            print(f"{name}: {e}", flush=True)
            checks.add(f"stage.{name}", False, error=str(e)[:2000])
        failed = [c["case"] for c in checks.cases if not c["ok"]]
        print(json.dumps({"stage": name, "s": time.perf_counter() - t0,
                          "cases": len(checks.cases), "failed": failed}), flush=True)
        cases += checks.cases
    bad = [c["case"] for c in cases if not c["ok"]]
    print(json.dumps({"failed": bad, "n_checks": len(cases)}), flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "head_dims_bringup.json"), "w") as f:
            json.dump(dict(report, checks=cases, paths=paths), f, indent=1, default=str)
    return 0 if not bad else 1


if __name__ == "__main__":
    sys.exit(main())
