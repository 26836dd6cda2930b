"""Staged bring-up and timing of K1, the paged-attention kernels, on one H100.

    python3 paged_bringup.py [TREE] [--seed N] [--stages a,b,...] [--decode-routes r,...]

Builds csrc/paged_attention.cu alone and prints its `paged_build` line
(registers, spill bytes and the HGMMA / UTMALDG / HMMA counts of each
instantiation), then runs the stages that --stages names (all by default),
each printing its failed checks (with --stages append alone, it builds
csrc/paged_append.cu alone instead):
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
          kv_len ranges at fp8 (`k1_decode_sweep`);
  options the options (window, softcap, ALiBi, leftpad) on both Hopper
          routes: where the tree's route sends them there, the checks in
          order (window, softcap, ALiBi, leftpad, all four; the chunk's also
          a non-causal right window) at the api decode shape
          (options_decode_inputs) and the chunk shape (options_chunk_inputs,
          fp8, int8, bf16); then `k1_options_times`: at the api decode shape
          with all four options and at the chunk shape (one 256-token chunk
          over 1024 fp8 keys) with all four and with ALiBi of slope 0, each
          route forced onto the same inputs (the decode kernel at the decode
          shape only), on the Timer and on device (every K1 kernel of the
          call, `paged_`), beside the option-free call, the bound and the
          library yardstick: flex_attention under torch.compile (softcap
          then ALiBi as its score_mod, the window, leftpad and kv_len as its
          block mask, GQA) over the live keys gathered as SDPA's are, or its
          error text where it does not compile. On a tree whose options
          still take the WMMA kernel (stage 0 on a parent), only its route
          and the option-free calls are timed;
  append  the append kernel (K2/K5/K6) bit for bit against its plain
          version at chip_smoke.py's shapes (decode b = 8, a 256-token
          chunk, the buckets, page 32, the 2048-row bucket and the other
          widths of APPEND_WIDTH_CASES), then `append_times`: decode, the
          chunk (fp8), page 32 and the 2048-row bucket on the Timer and on
          device (a profiler trace), the bucket also behind a read-only
          flush.
TREE (default: this checkout) is the root of a checkout whose package is
measured with this checkout's chip_smoke.py, so that a parent tree unpacked
beside this one is measured the same way in the same call. A descriptor or
layout mistake shows as wrong numbers, not a fault, so a change to K1 is
run here before chip_smoke.py. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import os
import sys
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)

STAGES = ("routes", "engine", "decode", "sweep", "options", "append")
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


def flex_yardstick(q, kp, vp, ks, vs, bt, lens, causal=True, window=(-1, -1), softcap=0.0,
                   alibi_slopes=None, cache_leftpad=None):
    """(T, call) of the options' library yardstick: flex_attention under
    torch.compile over the first T keys of each block-table row (T the
    largest kv_len rounded up to a page), gathered and dequantized to bf16
    as sdpa_over_pages does but not repeated over the GQA group
    (enable_gqa), with softcap then ALiBi as the score_mod and kv_len, the
    leftpad and the window as the block mask. Compiled here, by a first
    call; the caller times the call. Pools and scales of one layer."""
    from torch.nn.attention.flex_attention import create_block_mask, flex_attention

    b, sq, h, d = q.shape
    h_k, page = kp.shape[-3], kp.shape[-2]
    t_live = (int(lens.max()) + page - 1) // page * page
    idx = bt[:, :t_live // page].long()

    def dense(pool, scales):
        x = pool[idx].transpose(1, 2).reshape(b, h_k, t_live, d).float()
        if scales is not None:
            x = x * scales[idx].transpose(1, 2).reshape(b, h_k, t_live, 1)
        return x.bfloat16()

    kg, vg = dense(kp, ks), dense(vp, vs)
    qt = q.transpose(1, 2)
    n = lens.long()
    lp = torch.zeros_like(n) if cache_leftpad is None else cache_leftpad.long()
    slopes = None if alibi_slopes is None else alibi_slopes.float().expand(b, h).contiguous()
    wl, wr = window[0], (0 if causal else window[1])

    def mask_mod(bi, hi, qi, ki):
        qpos = n[bi] - sq + qi
        keep = (ki < n[bi]) & (ki >= lp[bi])
        if wr >= 0:
            keep = keep & (ki <= qpos + wr)
        if wl >= 0:
            keep = keep & (ki >= qpos - wl)
        return keep

    def score_mod(score, bi, hi, qi, ki):
        if softcap > 0.0:
            score = torch.tanh(score / softcap) * softcap
        if slopes is not None:
            score = score - slopes[bi, hi] * (n[bi] - sq + qi - ki).abs()
        return score

    block_mask = create_block_mask(mask_mod, b, None, sq, t_live, device="cuda")
    fn = torch.compile(flex_attention, dynamic=False)  # each shape compiled as it is

    def call():
        return fn(qt, kg, vg, score_mod=score_mod, block_mask=block_mask, enable_gqa=True)

    call()
    return t_live, call


def hopper_options():
    """Whether the measured tree's Hopper K1 kernels take the options (its
    decode kernel has an options instantiation); stage 0 on a parent tree
    says no."""
    from xf_flash_attention_cutlass_tpu_torch.ops import paged

    return "options" in inspect.signature(paged.decode_blocks_per_sm).parameters


def options_stage(gen, timer, checks, cfg):
    """The options stage (module docstring): its checks where the tree's
    route sends the options to the Hopper kernels, then `k1_options_times`."""
    from xf_flash_attention_cutlass_tpu_torch.ops import paged
    from xf_flash_attention_cutlass_tpu_torch.utils.testing import alibi_slopes_ref

    hopper = hopper_options()
    if hopper:
        q, kp, vp, bt, lens, full = cs.options_decode_inputs(gen, cfg)
        for name, opts in [(n, {n: x}) for n, x in full.items()] + [("all", full)]:
            cs.check_paged_options(checks, f"paged_attention.decode.options[{name}]", "decode",
                                   q, kp, vp, None, None, bt, lens, **opts)
        del kp, vp
        for dt in (torch.float8_e4m3fn, torch.int8, torch.bfloat16):
            q, kp, vp, ks, vs, bt, lens, full = cs.options_chunk_inputs(gen, dt, cfg)
            for name, opts in [(n, {n: x}) for n, x in full.items()] + [
                    ("all", full), ("right_window", dict(causal=False, window=(-1, 37)))]:
                cs.check_paged_options(
                    checks, f"paged_attention.prefill.options[{str(dt).split('.')[-1]},{name}]",
                    "wgmma", q, kp, vp, ks, vs, bt, lens, 1, **opts)
            del kp, vp, ks, vs

    def timed(q, kp, vp, ks, vs, bt, lens, layer, routes, opts):
        pick = (lambda x: x) if layer is None else (lambda x: None if x is None else x[layer])
        r = dict(bound=cs.k1_bound(q, kp, ks, bt, lens, **opts))
        for route in routes if hopper else ("wmma",):
            splits, call = cs.forced_route(route, q, kp, vp, ks, vs, bt, lens, layer, **opts)
            r[route] = dict(splits=splits, ms=timer.ms(call), device_ms=cs.device_ms(call,
                                                                                     "paged_"))
        free = cs.forced_route(paged.paged_plan(q.shape, kp.shape, kp.dtype, bt.shape[1])[0],
                               q, kp, vp, ks, vs, bt, lens, layer)[1]
        r["no_options"] = dict(ms=timer.ms(free), device_ms=cs.device_ms(free, "paged_"))
        try:
            t_live, flex = flex_yardstick(q, pick(kp), pick(vp), pick(ks), pick(vs), bt, lens,
                                          **opts)
            r["library"] = dict(name="flex_attention", keys=t_live, ms=timer.ms(flex))
        except Exception as e:  # a compile failure is the finding: its text stands in the row
            r["library"] = dict(name="flex_attention", error=f"{type(e).__name__}: {e}"[:2000])
        return r

    out = {}
    gen.manual_seed(gen.initial_seed())  # the timed inputs do not depend on the checks run
    q, kp, vp, bt, lens, full = cs.options_decode_inputs(gen, cfg)
    out["decode_all"] = timed(q, kp, vp, None, None, bt, lens, None, ("decode", "wgmma", "wmma"),
                              full)
    del kp, vp
    q, kp, vp, ks, vs, bt, lens = cs.paged_inputs(gen, torch.float8_e4m3fn, "prefill", cfg)
    full = dict(window=(300, 0), softcap=30.0,
                alibi_slopes=torch.from_numpy(alibi_slopes_ref(cfg.n_heads)).cuda(),
                cache_leftpad=torch.tensor([100], dtype=torch.int32, device="cuda"))
    zero = dict(alibi_slopes=torch.zeros(cfg.n_heads, device="cuda"))
    for name, opts in (("chunk_alibi0", zero), ("chunk_all", full)):
        out[name] = timed(q, kp, vp, ks, vs, bt, lens, 1, ("wgmma", "wmma"), opts)
    return out


def append_stage(gen, timer, checks, cfg):
    """The append stage (module docstring): its checks, then `append_times`."""
    times = {}
    for phase in ("decode", "prefill"):
        for dt in (torch.float8_e4m3fn, torch.int8, torch.bfloat16):
            r = cs.check_paged_append(gen, timer, checks, dt, phase, cfg)
            if dt == torch.float8_e4m3fn:
                times[phase] = r
    cs.check_bucket_append(gen, checks, cfg)
    times["page32"] = cs.check_page32_append(gen, timer, checks, cfg)
    times["bucket2048"] = cs.check_append_widths(gen, timer, checks, cfg)
    keys = ("ms", "clean_ms", "device_ms", "plain_ms", "bound", "rows")
    return {n: {k: r[k] for k in keys if k in r} for n, r in times.items()}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("tree", nargs="?", default=HERE)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--stages", default=",".join(STAGES))
    ap.add_argument("--decode-routes", default="decode,wgmma,wmma")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("paged_bringup.py: no CUDA device")
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    os.chdir(tree)
    from xf_flash_attention_cutlass_tpu_torch import _build
    from xf_flash_attention_cutlass_tpu_torch.models.llama import LlamaConfig

    stages = args.stages.split(",")
    k1 = stages != ["append"]
    _build.SOURCES = (("paged_attention",) if k1 else ()) + (
        ("paged_append",) if "append" in stages else ())
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 oracles in full f32
    cfg = LlamaConfig.llama8b()
    t0 = time.perf_counter()
    libs = _build.build_all()
    print(json.dumps({"tree": tree, "build_s": time.perf_counter() - t0}), flush=True)
    checks = cs.Checks()
    if k1 and hopper_options():  # the report of this checkout's instantiations
        cs.paged_build_report(checks, libs["paged_attention"])
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
    if "options" in stages:
        _, times = stage(checks, "d_options", lambda: options_stage(gen, timer, checks, cfg))
        print(json.dumps({"k1_options_times": times}), flush=True)
    if "append" in stages:
        _, times = stage(checks, "e_append", lambda: append_stage(gen, timer, checks, cfg))
        print(json.dumps({"append_times": times}), flush=True)
    print(cs.nvidia_smi(), flush=True)
    bad = [c["case"] for c in checks.cases if not c["ok"]]
    if bad:
        sys.exit(f"paged bring-up: {len(bad)} check(s) failed: {bad}")


if __name__ == "__main__":
    main()
