"""Bring-up of chip_smoke.py's MoE phase alone on one H100.

    python3 moe_bringup.py [--seed N] [--out DIR]

Builds every kernel source (one nvcc each, in parallel), then runs
chip_smoke.py's `serve_moe`: Mixtral-8x7B geometry at full width with INT8
weights over an FP8 page-256 KV cache, the cores' reference check against
the CPU, chunked and bucketed serving with their graph checks, the engine
saved mid-stream and resumed, one profiled decode step and two MoE training
steps at 2 layers. Prints every check as chip_smoke.py does, the failed
ones at the end, and the card's name and power limit; exits non-zero when a
check failed. With --out DIR the phase's report goes to DIR/moe_bringup.json.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

import chip_smoke


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("moe_bringup.py: no CUDA device")
    from xf_flash_attention_cutlass_tpu_torch import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = chip_smoke.nvidia_smi()
    print(smi, flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    checks, paths = chip_smoke.Checks(), {}
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    t0 = time.perf_counter()
    try:
        report = chip_smoke.serve_moe(gen, checks, paths, args.seed)
    finally:
        failed = [c["case"] for c in checks.cases if not c["ok"]]
        print(json.dumps({"failed": failed, "checks": len(checks.cases),
                          "seconds": time.perf_counter() - t0}), flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "moe_bringup.json"), "w") as f:
            json.dump(dict(report=report, checks=checks.cases, smi=smi), f, indent=1)
    print(smi, flush=True)


if __name__ == "__main__":
    main()
