"""Staged bring-up and tile timing of K3/K4's wgmma kernel on one H100.

    python3 qmm_bringup.py [--seed N]

Builds csrc/qmm.cu alone (about 17 s), prints its `qmm_build` line (and any
ptxas line that says wgmma was serialized), holds the weight conversion bit
for bit on every byte value, then checks the wgmma kernel stage by stage
under chip_smoke.py's 2x rule (bf16 weights without scale, then int8, then
fp8; small shapes, then ragged m, then Llama-8B shapes with split-K) for
each tile height (128 and 256 tokens), stopping a tile height at its first
failing stage. Last, it times one layer's seven projections at m = 17 to
2048 (int8; bf16 and fp8 at 2048) for each tile height that passed, beside
cuBLAS bf16. A descriptor or layout mistake shows as wrong
numbers, not a fault, so a change to the kernel is run here before
chip_smoke.py. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

import chip_smoke as cs
from xf_flash_attention_cutlass_tpu_torch import _build
from xf_flash_attention_cutlass_tpu_torch.quant import linear

DTYPES = {"bf16": torch.bfloat16, "int8": torch.int8, "fp8": torch.float8_e4m3fn}
LLAMA = sorted({(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096)})
LAYER = [(4096, 4096), (4096, 1024), (4096, 1024), (4096, 4096), (4096, 14336),
         (4096, 14336), (14336, 4096)]
STAGES = [("small", (128,), [(64, 128), (256, 256)]),
          ("ragged_m", (17, 100, 255), [(256, 256), (4096, 1024)]),
          ("llama_splitk", (64, 256, 2048), LLAMA)]
TIMED = [("int8", 17), ("int8", 64), ("int8", 128), ("int8", 256), ("int8", 512),
         ("int8", 1024), ("int8", 2048), ("bf16", 2048), ("fp8", 2048)]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("qmm_bringup.py: no CUDA device")
    _build.SOURCES = ("qmm",)
    t0 = time.perf_counter()
    lib = _build.build_all()["qmm"]
    print(json.dumps({"build_s": time.perf_counter() - t0}), flush=True)
    with open(f"{_build.BUILD_DIR}/qmm.log") as f:
        for line in f:
            if "serialized" in line:
                print(line.rstrip(), flush=True)
    checks = cs.Checks()
    cs.qmm_build_report(checks, lib)
    cs.check_qmm_conversion(checks)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    timer = cs.Timer()
    route_rows = linear.qmm_wgmma_rows
    passed = []
    for rows in (256, 128):
        linear.qmm_wgmma_rows = lambda m, r=rows: r
        ok = True
        for name in DTYPES:
            for stage, ms, shapes in STAGES:
                n0 = len(checks.cases)
                for m in ms:
                    for stacked in (True, False):
                        cs.check_qmm(gen, timer, checks, DTYPES[name], m, shapes, stacked,
                                     timed=False)
                failed = sum(not c["ok"] for c in checks.cases[n0:])
                print(json.dumps({"rows": rows, "dtype": name, "stage": stage,
                                  "cases": len(checks.cases) - n0, "failed": failed}), flush=True)
                ok = ok and failed == 0
                if not ok:
                    break
            if not ok:
                break
        if ok:
            passed.append(rows)
    for rows in passed:
        linear.qmm_wgmma_rows = lambda m, r=rows: r
        for name, m in TIMED:
            r = cs.check_qmm(gen, timer, checks, DTYPES[name], m, LAYER, True)
            print(json.dumps({"rows": rows, "dtype": name, "m": m, "ms": r["ms"],
                              "library_ms": r["library_ms"], "bound_ms": r["bound"][0]}),
                  flush=True)
    linear.qmm_wgmma_rows = route_rows
    print(cs.nvidia_smi(), flush=True)
    checks.raise_on_failure("qmm bring-up")


if __name__ == "__main__":
    main()
