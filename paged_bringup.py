"""Staged bring-up and timing of K1, the paged-attention kernels, on one H100.

    python3 paged_bringup.py [--seed N]

Builds csrc/paged_attention.cu alone and prints its `paged_build` line
(registers, spill bytes and the HGMMA / UTMALDG / HMMA counts of each
instantiation: the Hopper kernel's six, the WMMA kernel's 24), then checks
the kernels stage by stage with chip_smoke.py's checks under the 2x rule
against the plain version and the f32 oracle, and prints the failed checks
of each stage: (a) the route cases (PAGED_ROUTE_CASES: the Hopper kernel at
pages 16-256, d = 64 and 128, several splits, non-causal, a stacked layer,
ragged row tiles, dead rows; the WMMA kernel where the route sends it);
(b) the engine's shapes at fp8, int8 and bf16: a 256-token chunk over 1024
keys (the Hopper kernel) and decode at b = 8 (the WMMA kernel). Last, it
prints the chunk's and decode's times: the kernel, the WMMA kernel on the
same chunk, the plain version, SDPA over the live keys and over every page
of the table, and the bound. A descriptor or layout mistake shows as wrong
numbers, not a fault, so a change to K1 is run here before chip_smoke.py.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

import chip_smoke as cs
from xf_flash_attention_cutlass_tpu_torch import _build
from xf_flash_attention_cutlass_tpu_torch.models.llama import LlamaConfig


def stage(checks, name, fn):
    """Run fn and print the failures among the checks it added."""
    n0 = len(checks.cases)
    out = fn()
    new = checks.cases[n0:]
    failed = [c["case"] for c in new if not c["ok"]]
    print(json.dumps({"stage": name, "cases": len(new), "failed": failed}), flush=True)
    return not failed, out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("paged_bringup.py: no CUDA device")
    _build.SOURCES = ("paged_attention",)
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 oracles in full f32
    cfg = LlamaConfig.llama8b()
    t0 = time.perf_counter()
    lib = _build.build_all()["paged_attention"]
    print(json.dumps({"build_s": time.perf_counter() - t0}), flush=True)
    checks = cs.Checks()
    cs.paged_build_report(checks, lib)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    timer = cs.Timer()

    def engine_shapes():
        return {f"{phase}[{str(dt).split('.')[-1]}]":
                cs.check_paged_attention(gen, timer, checks, dt, phase, cfg)
                for dt in (torch.float8_e4m3fn, torch.int8, torch.bfloat16)
                for phase in ("prefill", "decode")}

    ok_a, _ = stage(checks, "a_route_cases", lambda: cs.check_paged_route_shapes(gen, checks))
    ok_b, timed = stage(checks, "b_engine_shapes", engine_shapes)
    keys = ("route", "ms", "wmma_ms", "ms_general", "plain_ms", "library_ms",
            "library_ms_all_pages", "library_keys", "bound")
    print(json.dumps({"k1_times": {n: {k: r.get(k) for k in keys} for n, r in timed.items()}}),
          flush=True)
    print(cs.nvidia_smi(), flush=True)
    bad = [c["case"] for c in checks.cases if not c["ok"]]
    if bad:
        sys.exit(f"paged bring-up: {len(bad)} check(s) failed: {bad}")


if __name__ == "__main__":
    main()
