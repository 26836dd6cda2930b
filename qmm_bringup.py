"""Staged bring-up and tile timing of K3/K4's Hopper kernels on one H100.

    python3 qmm_bringup.py [--seed N] [--stages wgmma,decode]

Builds csrc/qmm.cu alone (about 17 s), prints its `qmm_build` line (and any
ptxas line that says wgmma was serialized) and holds the weight conversion
of both Hopper kernels bit for bit on every byte value. Then, per stage
set:

- `wgmma` (m > 16): the wgmma kernel stage by stage under chip_smoke.py's
  2x rule (bf16 weights without scale, then int8, then fp8; small shapes,
  then ragged m, then Llama-8B shapes with split-K) for each tile height
  (128 and 256 tokens), stopping a tile height at its first failing stage;
  then one layer's seven projections timed at m = 17 to 2048 (int8; bf16
  and fp8 at 2048) for each tile height that passed, beside cuBLAS bf16.
- `decode` (m <= 16): the decode kernel in stages, each for int8, fp8 and
  bf16, stacked and single, stopping at the first failing stage: small
  shapes at one split (N = 8 and 16), ragged m (1, 5, 9, 16), Llama-8B
  shapes with the in-kernel split sum (the plan's splits, and forced ones),
  then determinism (two calls bit-equal, the counters all zero after).
  Then each projection and the lm_head timed at m = 1, 8 and 16 beside the
  WMMA bm16 kernel on the same inputs, cuBLAS bf16 and the byte bound, a
  sweep of split counts at m = 8 and 16, and at m = 8 the same timings
  behind a clean flush of the L2 (read, not written: chip_smoke.py's
  Timer(clean=True)) with the timer's floor under both flushes (one launch
  of a one-element kernel).

A descriptor or layout mistake shows as wrong numbers, not a fault, so a
change to a kernel is run here before chip_smoke.py. Needs a CUDA device.
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
LM_HEAD = (4096, 128256)
STAGES = [("small", (128,), [(64, 128), (256, 256)]),
          ("ragged_m", (17, 100, 255), [(256, 256), (4096, 1024)]),
          ("llama_splitk", (64, 256, 2048), LLAMA)]
TIMED = [("int8", 17), ("int8", 64), ("int8", 128), ("int8", 256), ("int8", 512),
         ("int8", 1024), ("int8", 2048), ("bf16", 2048), ("fp8", 2048)]
# (stage, m values, shapes, forced split counts: None is the plan's)
DECODE_STAGES = [("one_split", (8, 16), [(64, 128), (256, 256), (4096, 1024)], (1,)),
                 ("ragged_m", (1, 5, 9, 16), [(256, 256), (4096, 1024)], (None,)),
                 ("llama_splitk", (1, 8, 16), LLAMA, (None,)),
                 ("forced_splits", (8, 16), [(4096, 1024)], (2, 3, 7, 64))]
SWEEP = (1, 2, 4, 8, 13, 16)


def wgmma_stages(gen, timer, checks):
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


def decode_stages(gen, timer, checks) -> bool:
    for stage, ms, shapes, split_counts in DECODE_STAGES:
        n0 = len(checks.cases)
        for name in DTYPES:
            for m in ms:
                for stacked in (True, False):
                    for splits in split_counts:
                        cs.check_qmm(gen, timer, checks, DTYPES[name], m, shapes, stacked,
                                     timed=False, kind="decode" if splits else None,
                                     splits=splits)
        failed = [c["case"] for c in checks.cases[n0:] if not c["ok"]]
        print(json.dumps({"decode_stage": stage, "cases": len(checks.cases) - n0,
                          "failed": failed[:12]}), flush=True)
        if failed:
            return False
    n0 = len(checks.cases)
    cs.check_qmm_decode_repeat(gen, checks)
    failed = [c["case"] for c in checks.cases[n0:] if not c["ok"]]
    print(json.dumps({"decode_stage": "determinism", "cases": len(checks.cases) - n0,
                      "failed": failed}), flush=True)
    return not failed


def decode_times(gen, timer, checks):
    """Each shape at m = 1, 8, 16 on the decode kernel and on bm16, with
    cuBLAS bf16 and the bound, then m = 8 again behind a clean flush, with
    the floor of both timers; then the decode kernel at forced split counts
    (m = 8, 16), the plan's count marked."""
    clean = cs.Timer(clean=True)
    one = torch.zeros(1, device="cuda")
    print(json.dumps({"timer_floor_ms": timer.ms(lambda: one.add_(1)),
                      "clean_timer_floor_ms": clean.ms(lambda: one.add_(1))}), flush=True)
    for m, t, flush in ((1, timer, "written"), (8, timer, "written"), (16, timer, "written"),
                        (8, clean, "clean")):
        for shapes, stacked in ((LAYER, True), ([LM_HEAD], False)):
            dec, old = (cs.check_qmm(gen, t, checks, torch.int8, m, shapes, stacked,
                                     kind=kind) for kind in (None, "bm16"))
            print(json.dumps({"m": m, "flush": flush, "what": "layer" if stacked else "lm_head",
                              "ms": dec["ms"], "bm16_ms": old["ms"],
                              "library_ms": dec["library_ms"], "bound_ms": dec["bound"][0],
                              "shapes": [dict(K=a["K"], N=a["N"], ms=a["ms"], bm16_ms=b["ms"],
                                              library_ms=a["library_ms"],
                                              bound_ms=a["bound_ms"])
                                         for a, b in zip(dec["per_shape"], old["per_shape"])]}),
                  flush=True)
    for m in (8, 16):
        for K, N in LLAMA + [LM_HEAD]:
            wq, s = linear.quantize_weight(torch.randn((K, N), generator=gen, device="cuda")
                                           / K ** 0.5)
            x = torch.randn((m, K), generator=gen, device="cuda").bfloat16()
            n_kt = -(-K // 64)
            sweep = {}
            for splits in SWEEP:
                if splits <= n_kt and (splits == 1 or -(-N // 128) <= linear.QMM_DECODE_COUNTERS):
                    sweep[splits] = timer.ms(lambda: linear._qmm_cuda(
                        x, wq, s, "qmm.single", "decode", splits))
            print(json.dumps({"sweep_m": m, "K": K, "N": N,
                              "plan": linear.qmm_splits(m, N, K)[0], "ms_by_splits": sweep}),
                  flush=True)
            del wq, x


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--stages", default="wgmma,decode")
    args = ap.parse_args()
    stages = args.stages.split(",")
    if not torch.cuda.is_available():
        sys.exit("qmm_bringup.py: no CUDA device")
    _build.SOURCES = ("qmm", "qmm_f16")
    t0 = time.perf_counter()
    libs = _build.build_all()
    print(json.dumps({"build_s": time.perf_counter() - t0}), flush=True)
    with open(f"{_build.BUILD_DIR}/qmm.log") as f:
        for line in f:
            if "serialized" in line:
                print(line.rstrip(), flush=True)
    checks = cs.Checks()
    cs.qmm_build_report(checks, libs)
    cs.check_qmm_conversion(checks)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    timer = cs.Timer()
    if "decode" in stages and decode_stages(gen, timer, checks):
        decode_times(gen, timer, checks)
    if "wgmma" in stages:
        wgmma_stages(gen, timer, checks)
    print(cs.nvidia_smi(), flush=True)
    checks.raise_on_failure("qmm bring-up")


if __name__ == "__main__":
    main()
