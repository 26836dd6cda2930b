"""Staged bring-up of the dense flash family's f32 kernels (csrc/flash_f32.cu:
K7, K8, K9, K10 and K11 in f32) on one H100, before the whole chip_smoke.py.

    python3 flash_f32_bringup.py [--stages build,quick,phase,serve] [--out DIR]

`build` compiles flash_f32.cu and flash_probs.cu alone (the bf16 K8 is the
f32 dropout mask's yardstick) and prints the `flash_f32_build` line
(registers and spill bytes of each instantiation); `quick` runs
chip_smoke.py's untimed f32 cases (F32_FLASH_CASES, the packed prompts, the
(b, s, h, d) views) under the 2x rule against the f64 plain versions and
prints the failed checks; `phase` builds every source and runs phase 8
(`f32_flash_phase`: the kernels at Llama-8B shapes timed, f32 training, the
api's f32 calls); `serve` runs the f32 half of the serving paths (serve_f32
chunked, then serve_f32_bucketed on the same params, with the reference
check of the cores). Exits 1 when a check failed. Needs a CUDA device.
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
from xf_flash_attention_cutlass_tpu_torch.models.llama import LlamaConfig  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--stages", default="build,quick")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("flash_f32_bringup.py: no CUDA device")
    stages = args.stages.split(",")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    checks, paths, report, cases = cs.Checks(), {}, {}, []
    t0 = time.perf_counter()
    if "phase" in stages or "serve" in stages:
        _build.build_all()
    else:
        _build.SOURCES = ("flash_f32", "flash_probs")
        _build.build_all()
    report["build_s"] = time.perf_counter() - t0
    print(json.dumps({"build_s": report["build_s"]}), flush=True)
    report["flash_f32_build"] = cs.flash_f32_build_report(checks)
    cfg = LlamaConfig.llama8b()
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases += checks.cases
    for name in ("quick", "phase", "serve"):
        if name not in stages:
            continue
        checks, t0 = cs.Checks(), time.perf_counter()  # each stage fails on its own checks
        try:
            if name == "quick":
                cs.check_flash_f32(gen, None, checks, cfg, quick=True)
            elif name == "phase":
                report["flash_f32_kernels"], report["train_f32"] = cs.f32_flash_phase(
                    gen, cs.Timer(), checks, cfg, paths, 0)
            else:
                report["serving_f32"] = cs.serving_dtype_paths(gen, cfg, checks, paths, 0,
                                                               dtypes=(torch.float32,))
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
        with open(os.path.join(args.out, "flash_f32_bringup.json"), "w") as f:
            json.dump(dict(report, checks=cases, paths=paths), f, indent=1, default=str)
    return 0 if not bad else 1


if __name__ == "__main__":
    sys.exit(main())
