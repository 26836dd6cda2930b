"""Staged bring-up of the dense and paged kernels at every head dim on one
H100, before the whole chip_smoke.py. Two families of kernels, each brought
up alone:

    python3 head_dims_bringup.py [--family fwd|bwd] [--stages build,quick,...] [--out DIR]

`--family fwd` (the default): K1 and K7, the rungs 64, 128, 192 and 256 of
csrc/paged_attention.cu, csrc/flash_fwd.cu and K7's f32 kernel in
csrc/flash_f32.cu. `build` compiles their libraries alone (paged_attention in
its four variants, flash_fwd in its two, flash_f32) and prints the
`paged_build` and `wide_build` lines (registers, spill bytes and SASS counts
of every instantiation); `quick` runs chip_smoke.py's untimed head-dim cases
(`head_dims_phase`: every width of HEAD_DIMS on every K1 route and dtype
pair and on K7, the options at d = 96 and 256, and the resident blocks of
the decode and f32 kernels at every rung); `timed` times the rows at d = 96
and 256 (`head_dim_rows`); `serve` builds every source and serves
Phi-3-mini widths (`serve_phi3`: the reference check, then the chunked and
bucketed paths).

`--family bwd`: K8 and K9-K11, the rungs of csrc/flash_probs.cu,
csrc/flash_bwd.cu and their f32 kernels. `build` compiles the dense flash
libraries alone (flash_fwd, flash_probs and flash_bwd in their two variants
each, flash_f32) and prints the `flash_bwd_build`, `flash_probs_build`,
`flash_f32_build` and `bwd_wide_build` lines; `quick` runs
`check_bwd_head_dims` (every width of HEAD_DIMS, bf16, fp16 and f32, causal
and not, GQA, the options, the reproducibility of K9 and K10 and K11
against K10 at d = 96 and 256); `timed` times the rows at d = 96 and 256
(`bwd_head_dim_rows`); `train` builds every source and runs the two main
paths at Phi-3-mini widths (`train_phi3`, `api_phi3`).

`build` always runs; a failed build prints the compiler's error lines. Each
stage prints its failed checks; the report goes to
DIR/head_dims_bringup_<family>.json. Exits 1 when a check failed. Needs a
CUDA device.
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


def _timed(key, rows):
    print(json.dumps({key: rows}), flush=True)
    return {key: rows}


# family -> (the sources its build compiles alone, its build reports, its
# stages; the last stage runs a main path and builds every source)
FAMILIES = {
    "fwd": (
        ("paged_attention", "paged_attention_f16", "paged_attention_wide",
         "paged_attention_f16_wide", "flash_fwd", "flash_fwd_wide", "flash_f32"),
        lambda checks, libs: dict(paged_build=cs.paged_build_report(checks, libs),
                                  wide_build=cs.wide_build_report(checks, libs),
                                  flash_f32_build=cs.flash_f32_build_report(checks)),
        dict(quick=lambda gen, checks, paths: cs.head_dims_phase(gen, None, checks, quick=True),
             timed=lambda gen, checks, paths: _timed(
                 "head_dim_kernels", cs.head_dim_rows(gen, cs.Timer(), checks)),
             serve=lambda gen, checks, paths: dict(
                 serve_phi3=cs.serve_phi3(gen, checks, paths, 0)))),
    "bwd": (
        ("flash_fwd", "flash_fwd_wide", "flash_probs", "flash_probs_wide", "flash_bwd",
         "flash_bwd_wide", "flash_f32"),
        lambda checks, libs: dict(
            flash_bwd_build=cs.flash_bwd_build_report(checks, libs["flash_bwd"]),
            flash_probs_build=cs.probs_build_report(checks, libs["flash_probs"]),
            flash_f32_build=cs.flash_f32_build_report(checks),
            bwd_wide_build=cs.bwd_wide_build_report(checks, libs)),
        dict(quick=lambda gen, checks, paths: cs.check_bwd_head_dims(gen, checks),
             timed=lambda gen, checks, paths: _timed(
                 "bwd_head_dim_kernels", cs.bwd_head_dim_rows(gen, cs.Timer(), checks)),
             train=lambda gen, checks, paths: dict(
                 train_phi3=cs.train_phi3(gen, checks, paths, 0),
                 api_phi3=cs.api_phi3(gen, checks, paths, 0)))),
}


def compiler_errors(sources, max_lines=80):
    """The error lines of the sources' build logs."""
    out = []
    for name in sources:
        path = os.path.join(_build.BUILD_DIR, f"{name}.log")
        if os.path.exists(path):
            with open(path) as f:
                out += [f"{name}: {ln.rstrip()}" for ln in f if "error" in ln]
    return out[:max_lines]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--family", choices=sorted(FAMILIES), default="fwd")
    ap.add_argument("--stages", default="build,quick")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("head_dims_bringup.py: no CUDA device")
    sources, build_reports, stage_fns = FAMILIES[args.family]
    stages = args.stages.split(",")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    checks, paths, report, cases = cs.Checks(), {}, {}, []
    report["smi"] = cs.nvidia_smi()
    t0 = time.perf_counter()
    if list(stage_fns)[-1] not in stages:
        _build.SOURCES = sources
    try:
        libs = _build.build_all()
    except RuntimeError:
        print(json.dumps({"build_failed": compiler_errors(_build.SOURCES)}), flush=True)
        return 1
    report["build_s"] = time.perf_counter() - t0
    print(json.dumps({"build_s": report["build_s"], "smi": report["smi"]}), flush=True)
    report.update(build_reports(checks, libs))
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases += checks.cases
    for name, fn in stage_fns.items():
        if name not in stages:
            continue
        checks, t0 = cs.Checks(), time.perf_counter()  # each stage fails on its own checks
        try:
            report.update(fn(gen, checks, paths) or {})
        except RuntimeError as e:
            print(f"{name}: {e}", flush=True)
            checks.add(f"stage.{name}", False, error=str(e)[:2000])
        failed = [c["case"] for c in checks.cases if not c["ok"]]
        print(json.dumps({"stage": name, "s": time.perf_counter() - t0,
                          "cases": len(checks.cases), "failed": failed}), flush=True)
        cases += checks.cases
    report["device_traces"] = cs.DEVICE_TRACES
    bad = [c["case"] for c in cases if not c["ok"]]
    print(json.dumps({"failed": bad, "n_checks": len(cases)}), flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, f"head_dims_bringup_{args.family}.json"), "w") as f:
            json.dump(dict(report, checks=cases, paths=paths), f, indent=1, default=str)
    return 0 if not bad else 1


if __name__ == "__main__":
    sys.exit(main())
