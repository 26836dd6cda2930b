"""Staged bring-up and timing of K1, the paged-attention kernels, on one H100.

    python3 paged_bringup.py [--seed N] [--stages a,b,...] [--decode-routes r,...]

Builds csrc/paged_attention.cu alone and prints its `paged_build` line
(registers, spill bytes and the HGMMA / UTMALDG / HMMA counts of each
instantiation), then runs the stages that --stages names (all by default),
each printing its failed checks:
  routes  the route cases (PAGED_ROUTE_CASES of chip_smoke.py) under the 2x
          rule against the plain version and the f32 oracle;
  engine  the engine's shapes at fp8, int8 and bf16 (a 256-token chunk
          over 1024 keys and decode at b = 8) and the combine kernel on the
          decode's partials, checked, then timed (`k1_times`: the kernel,
          the WMMA kernel on the same chunk, the plain version, SDPA over
          the live keys and over every page of the table, the bound);
  decode  decode at b = 8 (32 / 8 heads, d = 128, page 256, one dead slot)
          at fp8, int8 and bf16, over the check's kv_lens (200-1533) and
          over the decode profile's (256-263): the routes --decode-routes
          names forced onto the same inputs (`decode`: the decode kernel and
          its combine, as paged_attention runs it; `wgmma`: the chunk
          route's kernel on a 64-row tile of 4 live rows; `wmma`: the first
          version), each with its split count, SDPA over the live keys and
          the bound (`k1_decode_times`; --decode-routes names the routes);
  sweep   the decode kernel's time at explicit split counts on both
          kv_len ranges at fp8 (`k1_decode_sweep`).
A descriptor or layout mistake shows as wrong numbers, not a fault, so a
change to K1 is run here before chip_smoke.py. Needs a CUDA device.
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

STAGES = ("routes", "engine", "decode", "sweep")
DECODE_RANGES = {"check": (200, 1533), "profile": (256, 264)}  # kv_lens drawn from [lo, hi)
SWEEP_SPLITS = (1, 2, 3, 4, 6, 8, 12, 16)


def stage(checks, name, fn):
    """Run fn and print the failures among the checks it added."""
    n0 = len(checks.cases)
    out = fn()
    new = checks.cases[n0:]
    failed = [c["case"] for c in new if not c["ok"]]
    print(json.dumps({"stage": name, "cases": len(new), "failed": failed}), flush=True)
    return not failed, out


def k1_decode_times(gen, timer, cfg, routes):
    """Decode timings at each dtype and kv_len range (module docstring)."""
    out = {}
    for dt in (torch.float8_e4m3fn, torch.int8, torch.bfloat16):
        for rng_name, kv_range in DECODE_RANGES.items():
            q, kp, vp, ks, vs, bt, lens = cs.paged_inputs(gen, dt, "decode", cfg, kv_range)
            ksl, vsl = (None, None) if ks is None else (ks[1], vs[1])
            t_live, library = cs.sdpa_over_live_keys(q, kp[1], vp[1], ksl, vsl, bt, lens)
            r = dict(kv_lens=[int(x) for x in lens.tolist()], library_ms=timer.ms(library),
                     library_keys=t_live, bound=cs.k1_bound(q, kp, ks, bt, lens))
            for route in routes:
                splits, call = cs.forced_route(route, q, kp, vp, ks, vs, bt, lens)
                r[route] = dict(splits=splits, ms=timer.ms(call))
            out[f"{str(dt).split('.')[-1]}[{rng_name}]"] = r
            del kp, vp, ks, vs
    return out


def k1_decode_sweep(gen, timer, cfg):
    """The decode route's time (kernel and combine) at explicit splits, fp8."""
    from xf_flash_attention_cutlass_tpu_torch.ops.paged import paged_attention

    out = {}
    for rng_name, kv_range in DECODE_RANGES.items():
        q, kp, vp, ks, vs, bt, lens = cs.paged_inputs(gen, torch.float8_e4m3fn, "decode", cfg,
                                                      kv_range)
        out[rng_name] = {s: timer.ms(lambda: paged_attention(
            q, kp, vp, bt, lens, layer_idx=1, num_splits=s, k_scales=ks, v_scales=vs))
            for s in SWEEP_SPLITS}
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--stages", default=",".join(STAGES))
    ap.add_argument("--decode-routes", default="decode,wgmma,wmma")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("paged_bringup.py: no CUDA device")
    stages = args.stages.split(",")
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
        out = {f"{phase}[{str(dt).split('.')[-1]}]":
               cs.check_paged_attention(gen, timer, checks, dt, phase, cfg)
               for dt in (torch.float8_e4m3fn, torch.int8, torch.bfloat16)
               for phase in ("prefill", "decode")}
        out["combine"] = cs.check_paged_combine(gen, timer, checks, cfg,
                                                out["decode[float8_e4m3fn]"]["splits"])
        return out

    if "routes" in stages:
        stage(checks, "a_route_cases", lambda: cs.check_paged_route_shapes(gen, checks))
    if "engine" in stages:
        _, timed = stage(checks, "b_engine_shapes", engine_shapes)
        keys = ("route", "splits", "ms", "wmma_ms", "ms_general", "plain_ms", "library_ms",
                "library_ms_all_pages", "library_keys", "bound")
        print(json.dumps({"k1_times": {n: {k: r.get(k) for k in keys}
                                       for n, r in timed.items()}}), flush=True)
    if "decode" in stages:
        print(json.dumps({"k1_decode_times": k1_decode_times(
            gen, timer, cfg, args.decode_routes.split(","))}), flush=True)
    if "sweep" in stages:
        print(json.dumps({"k1_decode_sweep": k1_decode_sweep(gen, timer, cfg)}), flush=True)
    print(cs.nvidia_smi(), flush=True)
    bad = [c["case"] for c in checks.cases if not c["ok"]]
    if bad:
        sys.exit(f"paged bring-up: {len(bad)} check(s) failed: {bad}")


if __name__ == "__main__":
    main()
