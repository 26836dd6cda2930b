"""Bring-up of chip_smoke.py's sequence-parallel phase alone on one H100.

    python3 cp_bringup.py [--seed N] [--out DIR]

Builds every kernel source (one nvcc each, in parallel), then runs
chip_smoke.py's `serve_cp` inside a one-rank NCCL group: at Llama-8B
attention width, `ring_attention` (causal and not), `ring_attention_zigzag`
and `ulysses_attention` at cp = 1 over 8192 tokens, forward and backward,
against `flash_attention` and the f32 oracle; then the cp = 4 schedule in
one process over 16384 tokens, with each hop kind's times, each rank's
device time and the dense kernels' times. Every main path is driven as in
chip_smoke.py (its kernels launched, no plain version). Prints every check
as chip_smoke.py does, the failed ones at the end, and the card's name and
power limit; exits non-zero when a check failed. With --out DIR the phase's
report goes to DIR/cp_bringup.json. Needs a CUDA device.
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
        sys.exit("cp_bringup.py: no CUDA device")
    from xf_flash_attention_cutlass_tpu_torch import _build
    from xf_flash_attention_cutlass_tpu_torch.models.llama import LlamaConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = chip_smoke.nvidia_smi()
    print(smi, flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    checks, paths, report = chip_smoke.Checks(), {}, None
    gen = torch.Generator(device="cuda").manual_seed(args.seed + 11)
    t0 = time.perf_counter()
    try:
        with chip_smoke.one_rank_group():
            report = chip_smoke.serve_cp(gen, LlamaConfig.llama8b(), checks, paths)
    finally:
        failed = [c["case"] for c in checks.cases if not c["ok"]]
        print(json.dumps({"failed": failed, "checks": len(checks.cases),
                          "seconds": time.perf_counter() - t0}), flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "cp_bringup.json"), "w") as f:
            json.dump(dict(report=report, checks=checks.cases, paths=paths, smi=smi), f, indent=1)
    print(smi, flush=True)


if __name__ == "__main__":
    main()
