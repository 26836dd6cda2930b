"""On-card smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py [--seed N] [--out DIR]

Phases, each of which raises (exit code != 0) when it fails:

1. Build every CUDA kernel from xf_flash_attention_cutlass_tpu_torch/csrc
   (one nvcc per source, in parallel) and print the seconds it took, then
   what the build made of K7 (`flash_fwd_build`): each instantiation's
   registers and spill bytes from -Xptxas -v, and the HGMMA (wgmma),
   UTMALDG (TMA load) and HMMA (mma.sync) counts of its SASS; it fails
   unless HGMMA and UTMALDG are above 0, HMMA is 0 and the option-free
   instantiations spill nothing. The same for K3/K4 (`qmm_build`), per
   instantiation: it fails unless each wgmma instantiation holds HGMMA and
   UTMALDG and no HMMA, each decode one HMMA (mma.sync) and UTMALDG, no
   HGMMA and no spill, and the WMMA ones (ragged operands) keep their HMMA;
   and unless the occupancy calculator gives every decode instantiation the
   resident blocks an SM that its split plan counts.
   The same for K9-K11 (`flash_bwd_build`), per instantiation, with any
   ptxas line saying wgmma was serialized: it fails unless every K9, K10
   and K11 instantiation holds HGMMA and UTMALDG and no HMMA and the
   option-free ones spill nothing. The same for K1 (`paged_build`): it
   fails unless the twelve instantiations of its Hopper chunk kernel (six
   option-free, six with the options) hold HGMMA and UTMALDG, no HMMA and
   no spill, the 24 of its decode kernel HMMA (mma.sync) and UTMALDG and
   no spill, the two of its combine kernel no spill, and the 24 WMMA ones
   keep their HMMA; and unless the CUDA occupancy calculator gives every
   decode instantiation, with the options or without, the resident blocks
   an SM that the decode route's split heuristic counts. The same
   for K8 (`flash_probs_build`): it fails unless its eight instantiations
   hold HGMMA and UTMALDG and no HMMA, the four that store by TMA UTMASTG
   (TMA store), and none spills.
2. Hold each kernel against its plain PyTorch version on the card, at the
   shapes the main paths give it (Llama-8B widths), and time the kernel, the
   plain version and, where one exists, a PyTorch library call that computes
   the same function (a yardstick only; the port never calls it). Bucketed
   prefill's shapes are all covered: K3 at m = 256-2048, K5 appending a whole
   bucket at position 0 through a trash-tailed block-table row, K7 at every
   bucket, and the append kernel alone at the largest bucket (2048 rows,
   timed on the Timer, behind a read-only flush and on device) and at
   head dims 64, 32, 192, 40 and 66 (APPEND_WIDTH_CASES), bit for bit.
   K1's chunk (the Hopper chunk kernel) and decode (the decode
   kernel and its combine) at fp8, int8 and bf16 each launch the route
   paged_plan names; both are also timed through the WMMA kernel, decode
   through the chunk kernel forced onto its rows too, and K1's library
   yardstick is SDPA over the live keys (the 4096 keys of every page beside
   it); the combine kernel is held against combine_partials on the decode's
   partials; the route cases (PAGED_ROUTE_CASES: pages 12-256, d 64 and
   128, splits, non-causal, a stacked layer, ragged row tiles, decode at
   groups 1-8 and sq 1-4 with kv_len < 64 and more splits than live tiles,
   an option on each Hopper kernel, odd pages with and without an option on
   the WMMA kernel) hold every route to its plain version and the oracle.
   K3/K4's decode kernel (m <= 16) is checked for bf16 weights without
   scale, int8 and fp8, stacked and single, at m = 1, 8 and 16 on Llama-8B
   shapes, two calls bit for bit with its split
   counters all zero after, and every k-tile a split; one layer's
   projections and the lm_head are timed at m = 1, 8 (and 16) beside the
   WMMA bm16 kernel on the same inputs (`qmm_decode_times`, each shape's
   ms). The wgmma kernel (m > 16) is checked for the same weights at
   m = 17, 64, 100, 255, 256 and 2048 and timed at m = 256 and 2048 beside
   the WMMA bm64 kernel; both Hopper kernels' weight conversion is held bit
   for bit on every byte value; `qmm_host_us` is the host's time for one
   launch of each route. The
   dense flash kernels are also held against a dense f32 oracle
   (utils/testing.py): K7 at the bucketed-prefill and training shapes and at
   s = 2048 causal under the 2x rule (bucket 1024, the training shape and
   s = 2048 timed), K9/K10/K11 at the training shape under the 3x rule, K9 and
   K10 each run twice bit for bit, K11's dK/dV equal to K10's and its dQ
   against K9's. Shapes off the paths (ragged matmuls, page 16 and 32,
   head_dim 64, unaligned lengths, window, softcap, segment ids, GQA 4:1) are
   checked too, untimed; K7 also where its tiling can break it
   (FLASH_FWD_TILING: sq = 1, sk below one tile, kv_lens and window edges
   inside a tile, fp16 at d = 64), and on (b, s, h, d) views, bit for bit
   against contiguous copies and launching its kernel alone (a profiler
   trace); K9-K11 where their tiling can break them (FLASH_BWD_TILING, then
   positions with per-row ALiBi over packed prompts and ALiBi with dropout,
   both routes), and on the model's (b, s, h, d) views (no copy of q, k, v or
   dO, outputs in their layout, the same bits as contiguous copies); one
   Llama-8B attention_block launches nothing between attn_qkv's kernels and
   K7's. K1, K7 and K9-K11 at the main paths' shapes are also timed in the
   instantiation that carries the options, with ALiBi of slope 0. The API's
   options at the `api` path's shapes: K7 with ALiBi and dropout and with
   per-row slopes and explicit positions over the packed serving prompts, K8
   (the probability plane) on the dense case and on the packed plane, entry by
   entry against its plain version (its dropout signs equal, 0 mismatches),
   and at PROBS_CASES (sk % 4 != 0, d = 64 with GQA, fp16, windows with
   softcap, segment ids, one query row, (b, s, h, d) views), then its shares
   at the dense shape and on the packed plane (`probs_shares`: dropout 0,
   no ALiBi, non-causal, every tile dead),
   K9/K10/K11 with ALiBi and dropout (3x rule against the oracle's gradients,
   the mask taken from K8's signs) and over the packed prompts, K1 with each
   of window, softcap, ALiBi and leftpad and all four at the api decode
   shape (the decode kernel's options instantiation,
   `paged_attention.decode.options`) and at a 256-token chunk over fp8,
   int8 and bf16 pools, with a non-causal right window too (the chunk
   kernel's, `paged_attention.prefill.options`), the WMMA kernel's options
   instantiation forced onto the same inputs and timed beside them, and the
   realized drop fraction within 0.01 of p.
3. Train: Llama-8B widths, all 32 layers, bf16, one 1024-token batch from
   the seed, three plain SGD steps through K7 forward and K9/K10 backward
   and one through K11; every loss finite and below the one before.
4. Serve Llama-8B (all 32 layers, full width, random weights from the seed)
   with INT8 weights and an FP8-e4m3 paged KV cache through DecodeEngine:
   first a reference check of the chunk, decode and bucketed prefill cores
   against the plain versions on the CPU (2 layers), then 8 greedy requests
   with 256-token chunked prefill, the same 8 requests with bucketed
   prefill (K7), one bucketed admission of the largest prompt timed and
   profiled (`admission_profile`: device time by kernel, K3's share), and a
   profiled decode window (`decode_profile`: device time and kernel
   launches a step, K1's and K3's by route; it fails if K3 runs any kernel
   but the decode kernel there, or a split-K reduction). After the chunked run, the chunked
   prefill of the same prompts is profiled by kernel
   (`chunked_prefill_profile`, K1's share on each route). Both serving
   runs decode through K1's and K3/K4's decode kernels and never the WMMA
   ones.
5. Drive the public API (`api.py`) at Llama-8B attention width: dense
   attention with ALiBi, dropout and the probability plane, and its
   gradient; packed varlen over the serving prompts with per-sequence ALiBi,
   its gradient and the plane of a subset; paged varlen over a bf16 page-256
   cache of those prompts, then again with window, softcap and ALiBi;
   KV-cache decode with a rotary append on that cache, and on a dense cache
   with softcap, window, ALiBi and leftpad (both options calls on K1's
   Hopper kernels, never the WMMA one).
   Its K1 outputs are held against K1's plain version and the oracle on the
   same inputs. Then each step is called again, warm: host-clock times over
   five calls, device time from a profiler trace, and the device time of the
   copies of the caller's caches into K1's page layout. Each main path
   (training, chunked and bucketed serving, the API) runs with the launch
   counters cleared just before and read just after, to show that every
   kernel of the path ran and no plain version did.
6. Print the seconds of each phase, the `kernels` JSON line, the card's
   name and power limit, and, last,
   {"ok": true, "device": {...}}.

Needs a CUDA device; exits with an error and prints no result without one.
With --out DIR, the details of every phase also go to DIR/chip_smoke.json.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12  # dense bf16 tensor-core peak, H100 SXM
REPS = 20  # timed launches per measurement (plain versions: PLAIN_REPS)
PLAIN_REPS = 3
# calls of each api step under one trace: with two, a trace that lost one
# call's first kernels (the layout copies) read 0.127 ms for a 0.22 ms
# step; ten bound such a loss to a tenth
API_TRACED_CALLS = 10
L2_FLUSH_BYTES = 128 << 20  # > the 50 MB L2: every timed launch starts cold
# the card spins this many cycles (about 2.5 ms) before each timed call, so
# that the host has queued the whole call before it starts: the events then
# time the device's work, not the host's launch overhead
SLEEP_CYCLES = 5_000_000


def parse_args():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="directory for chip_smoke.json")
    return ap.parse_args()


# ---- timing and bounds -------------------------------------------------------

class Timer:
    """CUDA-event time of one call on the device, averaged over calls that
    each start with a cold L2 (a 128 MB buffer is rewritten before every
    call) and are queued whole behind a spin of the card. With clean=True
    the buffer is read instead of written, so the L2 starts cold but holds
    no dirty lines that the call's own reads would have to write back."""

    def __init__(self, clean=False):
        self.flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
        self.clean = clean

    def ms(self, fn, reps=REPS) -> float:
        fn()  # warm-up: first-launch costs stay out of the number
        torch.cuda.synchronize()
        pairs = []
        for _ in range(reps):
            torch.cuda._sleep(SLEEP_CYCLES)
            if self.clean:
                self.flush.max()
            else:
                self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            pairs.append((start, end))
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in pairs) / reps


def device_ms(fn, kernel, reps=REPS):
    """Device time per call of fn of the kernels whose name holds `kernel`,
    from a profiler trace of `reps` calls, each behind a read-only pass over
    a 128 MB buffer (the L2 starts cold and clean): the kernel alone,
    without the launch and event costs that the Timer includes. None when
    the trace holds no such kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(TRACE_SETTLE_S)
        for _ in range(reps):
            flush.max()
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA and kernel in e.key)
    return us / 1e3 / reps if us > 0 else None


def bound(n_bytes: float, n_ops: float) -> tuple:
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and
    operations over the bf16 tensor-core peak."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / BF16_FLOPS
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


class Checks:
    """Per-case results, each printed as a JSON line; `raise_on_failure`
    ends a phase with an error when any of its cases failed."""

    def __init__(self):
        self.cases = []

    def add(self, name, ok, **info):
        info = dict(case=name, ok=bool(ok), **info)
        self.cases.append(info)
        print(json.dumps(info), flush=True)

    def raise_on_failure(self, phase):
        bad = [c["case"] for c in self.cases if not c["ok"]]
        if bad:
            raise RuntimeError(f"{phase}: {len(bad)} case(s) failed: {bad}")


# ---- phase 2: kernels against their plain versions ---------------------------

def kv_pools(gen, kv_dtype, layers, pages, h_k, page, d):
    """Random K/V pools (layers, pages + 1 trash, h_k, page, d) in kv_dtype,
    with f32 per-token scales for int8/fp8."""
    from xf_flash_attention_cutlass_tpu_torch.quant.kv import quantize_kv

    shape = (layers, pages + 1, h_k, page, d)
    out = []
    for _ in range(2):
        x = torch.randn(shape, generator=gen, device="cuda")
        if kv_dtype == torch.bfloat16:
            out.append((x.bfloat16(), None))
        else:
            name = "int8" if kv_dtype == torch.int8 else "fp8_e4m3"
            vals, sc = quantize_kv(x, name)
            out.append((vals, sc[..., 0].contiguous()))
        del x
    (kp, ks), (vp, vs) = out
    return kp, vp, ks, vs


def sdpa_over_pages(q, kp, vp, ks, vs, bt, lens, T):
    """The library yardstick of K1: SDPA over the first T keys of each
    block-table row, gathered, dequantized and expanded over the GQA group
    (bf16), with the bottom-right causal mask and kv_len; rows that see no
    key are unmasked (SDPA gives NaN on them; they are not compared)."""
    b, sq, h, d = q.shape
    h_k, page = kp.shape[1], kp.shape[2]
    pages = (T + page - 1) // page
    idx = bt[:, :pages].long()

    def dense(pool, scales):
        x = pool[idx].transpose(1, 2).reshape(b, h_k, pages * page, d)[:, :, :T].float()
        if scales is not None:
            x = x * scales[idx].transpose(1, 2).reshape(b, h_k, pages * page, 1)[:, :, :T]
        return x.bfloat16().repeat_interleave(h // h_k, dim=1)

    kg, vg = dense(kp, ks), dense(vp, vs)
    kcol = torch.arange(T, device=q.device)
    qpos = lens.long()[:, None] - sq + torch.arange(sq, device=q.device)[None]  # (b, sq)
    mask = (kcol[None, None] <= qpos[..., None]) & (kcol[None, None] < lens.long()[:, None, None])
    mask = mask[:, None]  # (b, 1, sq, T)
    mask[lens == 0] = True
    qt = q.transpose(1, 2)
    return lambda: F.scaled_dot_product_attention(qt, kg, vg, attn_mask=mask)


def paged_inputs(gen, kv_dtype, phase, cfg, kv_range=(200, 1533)):
    """K1's inputs at the engine's shapes: two layers of page-256 pools of
    64 pages (+ a trash page), 16-page block tables, q (b, sq, h, d) bf16.
    Decode: b = 8, sq = 1, kv_lens drawn from kv_range, the last slot
    inactive (kv_len 0 on the trash page); prefill: one 256-token chunk at
    kv_len 1024. Returns (q, k_pool, v_pool, k_scales, v_scales, bt, lens)."""
    h, h_k, d, page, max_pages = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, 256, 16
    b, sq = (8, 1) if phase == "decode" else (1, 256)
    n_pages = 64
    kp, vp, ks, vs = kv_pools(gen, kv_dtype, 2, n_pages, h_k, page, d)
    bt = torch.stack([torch.randperm(n_pages, generator=gen, device="cuda")[:max_pages]
                      for _ in range(b)]).int()
    if phase == "decode":
        lens = torch.randint(*kv_range, (b,), generator=gen, device="cuda").int()
        lens[-1] = 0  # an inactive slot: trash page, O = 0, LSE = -inf
        bt[-1] = n_pages
    else:
        lens = torch.tensor([1024], dtype=torch.int32, device="cuda")  # 4th chunk
    q = torch.randn((b, sq, h, d), generator=gen, device="cuda").bfloat16()
    return q, kp, vp, ks, vs, bt, lens


def sdpa_over_live_keys(q, kp, vp, ks, vs, bt, lens):
    """(T, SDPA over the first T keys): K1's library yardstick, T the largest
    kv_len rounded up to a page. Pools and scales of one layer."""
    page = kp.shape[-2]
    t_live = (int(lens.max()) + page - 1) // page * page
    return t_live, sdpa_over_pages(q, kp, vp, ks, vs, bt, lens, t_live)


def k1_bound(q, kp, ks, bt, lens, causal=True, window=(-1, -1), cache_leftpad=None, **_):
    """K1's (bound_ms, bound_by) on these inputs: q, the block tables and the
    K/V rows (and scales) any row sees read once, O (bf16) and LSE written
    once; 4 * d operations per (query head, visible key). Row t of an entry
    sees the keys from its window start and the leftpad (0 without them) to
    its causal or right limit and kv_len; softcap and ALiBi (the other
    keywords) add a few operations a score, not counted."""
    b, sq, h, d = q.shape
    wl, wr = window[0], (0 if causal else window[1])
    pads = [0] * b if cache_leftpad is None else [max(0, int(x)) for x in cache_leftpad.tolist()]
    visible = read = 0
    for n, lp in zip((int(x) for x in lens.tolist()), pads):
        spans = [(max(lp, qpos - wl) if wl >= 0 else lp,
                  min(n - 1, qpos + wr) if wr >= 0 else n - 1)
                 for qpos in range(n - sq, n)]
        spans = [(lo, hi) for lo, hi in spans if hi >= lo]
        visible += sum(hi - lo + 1 for lo, hi in spans)
        if spans:
            read += max(hi for _, hi in spans) - min(lo for lo, _ in spans) + 1
    kv_row = 2 * d * kp.element_size() + (8 if ks is not None else 0)  # K, V, scales
    out_bytes = q.numel() * 2 + b * h * sq * 4
    by = nbytes(q, bt, lens) + out_bytes + read * kp.shape[-3] * kv_row
    return bound(by, 4 * d * h * visible)


def forced_route(route, q, kp, vp, ks, vs, bt, lens, layer_idx=1, **opts):
    """(splits, call) of K1 through the kernel `route` names on inputs of
    layer `layer_idx` (None: one layer), causal and option-free unless
    `opts` (paged_attention's causal, window, softcap, alibi_slopes,
    cache_leftpad) say otherwise, with the split count paged_plan gives or,
    for another route forced onto the same rows, the heuristic over that
    kernel's row tile."""
    from xf_flash_attention_cutlass_tpu_torch.ops import paged

    b, sq, h, d = q.shape
    h_k = kp.shape[-3]
    route_now, splits = paged.paged_plan(q.shape, kp.shape, kp.dtype, bt.shape[1], **opts)
    if route != route_now:
        rows = sq * (h // h_k)
        splits = paged.resolve_num_splits(0, b, h_k, rows, bt.shape[1],
                                          paged.route_row_tile(route, rows))
    kw = dict(causal=True, window=(-1, -1), softcap=0.0, alibi_slopes=None, cache_leftpad=None)
    kw.update(opts)
    return splits, lambda: paged._paged_attention_cuda(
        q, kp, vp, layer_idx, bt, lens, 1.0 / math.sqrt(d), kw["causal"], kw["window"],
        kw["softcap"], kw["alibi_slopes"], kw["cache_leftpad"], splits, ks, vs, route)


def check_paged_attention(gen, timer, checks, kv_dtype, phase, cfg):
    """K1 at the engine's shapes: decode b=8, sq=1 over kv_lens of the
    serving prompts (the WMMA kernel), or one 256-token chunk at b=1 (the
    Hopper kernel; also timed through the WMMA kernel on the same inputs).
    The tolerance is the 2x rule's: twice the error of the dense oracle in
    the working dtype against the dense float32 oracle (utils/testing.py),
    plus 1e-5. Both the kernel's distance from its plain version and its
    error against the f32 oracle must stay within it, and the call must
    launch the route paged_plan names."""
    from xf_flash_attention_cutlass_tpu_torch import _build
    from xf_flash_attention_cutlass_tpu_torch.ops.paged import (
        paged_attention,
        paged_attention_ref,
        paged_plan,
        route_label,
    )
    from xf_flash_attention_cutlass_tpu_torch.utils.testing import paged_attention_oracle

    h, h_k, d, page, max_pages = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, 256, 16
    q, kp, vp, ks, vs, bt, lens = paged_inputs(gen, kv_dtype, phase, cfg)
    b, sq = q.shape[:2]
    sc = {} if ks is None else dict(k_scales=ks, v_scales=vs)
    sc1 = {} if ks is None else dict(k_scales=ks[1], v_scales=vs[1])

    def kernel():
        return paged_attention(q, kp, vp, bt, lens, layer_idx=1, **sc)

    route, splits = paged_plan(q.shape, kp.shape, kp.dtype, max_pages)
    label = route_label(route, sq * (h // h_k))

    def plain():
        return paged_attention_ref(q, kp[1], vp[1], bt, lens, num_splits=splits, **sc1)

    n0 = _build.LAUNCHES[label]
    o, lse = kernel()
    launched = _build.LAUNCHES[label] - n0 == 1
    o_plain, lse_plain = plain()
    o32, l32 = paged_attention_oracle(q, kp[1], vp[1], bt, lens, **sc1)
    olp, llp = paged_attention_oracle(q, kp[1], vp[1], bt, lens, upcast=False, **sc1)
    torch.cuda.synchronize()
    live = lens > 0
    plain_err, err, lp_err = max_err(o, o_plain), max_err(o, o32), max_err(olp, o32)
    lse_plain_err = max_err(lse[live], lse_plain[live])
    lerr = max_err(lse[live], l32[live])
    llp_err = max_err(llp[live], l32[live])
    dead_ok = bool((o[~live] == 0).all()) and bool(torch.isneginf(lse[~live]).all())
    tol, ltol = 2 * lp_err + 1e-5, 2 * llp_err + 1e-5
    ok = (bool(torch.isfinite(o).all()) and dead_ok and plain_err <= tol and err <= tol
          and lse_plain_err <= ltol and lerr <= ltol and launched)
    name = f"paged_attention.{phase}[{str(kv_dtype).split('.')[-1]}]"
    checks.add(name, ok, max_abs_err=plain_err, tolerance=tol, err_vs_f32_oracle=err,
               lse_err=lse_plain_err, lse_err_vs_f32_oracle=lerr, lse_tolerance=ltol,
               dead_rows_ok=dead_ok, num_splits=splits, route=route, launched=launched)

    # library yardstick: SDPA over the live keys (the largest kv_len rounded
    # up to a page); beside it, the earlier yardstick over every page of the
    # table (max_pages * page keys), which did up to 4x the work
    ksl, vsl = (None, None) if ks is None else (ks[1], vs[1])
    t_live, library = sdpa_over_live_keys(q, kp[1], vp[1], ksl, vsl, bt, lens)
    library_all = sdpa_over_pages(q, kp[1], vp[1], ksl, vsl, bt, lens, max_pages * page)
    zero = torch.zeros(h, device="cuda")  # ALiBi of slope 0: the options' kernel, same result
    out = dict(
        ms=timer.ms(kernel), plain_ms=timer.ms(plain, PLAIN_REPS),
        ms_general=timer.ms(lambda: paged_attention(q, kp, vp, bt, lens, layer_idx=1,
                                                    alibi_slopes=zero, **sc)),
        library_ms=timer.ms(library), library_ms_all_pages=timer.ms(library_all),
        library_keys=t_live, bound=k1_bound(q, kp, ks, bt, lens), err=plain_err, tol=tol,
        route=route, splits=splits,
    )
    # the first version on the same inputs; at decode also the Hopper chunk
    # kernel forced onto the rows (a 64-row tile of group * sq live rows)
    for other in ("wmma",) + (("wgmma",) if route == "decode" else ()):
        out[f"{other}_ms"] = timer.ms(forced_route(other, q, kp, vp, ks, vs, bt, lens)[1])
    return out


def check_paged_append(gen, timer, checks, kv_dtype, phase, cfg):
    """K2 (decode: 8 rows at scattered positions) and K5 (a 256-token chunk):
    the kernel's pools and scales must equal the plain version's bit for bit
    on every page but the trash page."""
    from xf_flash_attention_cutlass_tpu_torch.ops.paged_append import (
        paged_append,
        paged_append_ref,
    )

    h_k, d, page, max_pages, n_pages = cfg.n_kv_heads, cfg.head_dim, 256, 16, 64
    b, sq = (8, 1) if phase == "decode" else (1, 256)
    quant = kv_dtype != torch.bfloat16
    shape = (2, n_pages + 1, h_k, page, d)
    kp = torch.zeros(shape, dtype=kv_dtype, device="cuda")
    vp = torch.zeros_like(kp)
    ks = torch.zeros(shape[:-1], device="cuda") if quant else None
    vs = torch.zeros_like(ks) if quant else None
    perm = torch.randperm(n_pages, generator=gen, device="cuda").int()
    bt = torch.full((b, max_pages), n_pages, dtype=torch.int32, device="cuda")
    for i in range(b):
        bt[i, :6] = perm[6 * i: 6 * i + 6]
    if phase == "decode":
        pos = torch.randint(0, 6 * page, (b,), generator=gen, device="cuda").int()
    else:
        pos = torch.tensor([768], dtype=torch.int32, device="cuda")
    kn = (torch.randn((b, sq, h_k, d), generator=gen, device="cuda") * 3).bfloat16()
    vn = torch.randn((b, sq, h_k, d), generator=gen, device="cuda").bfloat16()
    kn[0, 0, 0] = 0  # amax 0: scale 1
    ref = [None if t is None else t[1].clone() for t in (kp, vp, ks, vs)]
    sc = dict(k_scales=ks, v_scales=vs) if quant else {}

    def kernel():
        paged_append(kp, vp, kn, vn, bt, pos, layer_idx=1, **sc)

    def plain():
        paged_append_ref(ref[0], ref[1], kn, vn, bt, pos, ref[2], ref[3])

    kernel()
    plain()
    torch.cuda.synchronize()
    equal = True
    for got, want in zip((kp, vp, ks, vs), ref):
        if got is not None:
            a, w = got[1, :n_pages].contiguous(), want[:n_pages].contiguous()
            equal &= bool(torch.equal(a.view(torch.uint8), w.view(torch.uint8)))
    name = f"paged_append.{phase}[{str(kv_dtype).split('.')[-1]}]"
    checks.add(name, equal, max_abs_err=0.0 if equal else float("nan"), tolerance=0.0,
               criterion="bit-equal pools and scales off the trash page")
    rows = b * sq * h_k
    by = nbytes(kn, vn, bt, pos) + 2 * rows * (d * kp.element_size() + (4 if quant else 0))
    return dict(ms=timer.ms(kernel), device_ms=device_ms(kernel, APPEND_KERNEL),
                plain_ms=timer.ms(plain, PLAIN_REPS), library_ms=None,
                bound=bound(by, 0), err=0.0 if equal else float("nan"), tol=0.0)


APPEND_KERNEL = "paged_append_kernel"  # the append kernel's name in a profiler trace


def append_case(gen, kv_dtype, b, sq, h_k, d, page, n_pages, max_pages, positions):
    """Zeroed pools (n_pages + 1 trash, h_k, page, d) of kv_dtype with f32
    scales for int8 / fp8, a block table of distinct pages per row with the
    trash page past its first n_pages // b entries, bf16 rows (b, sq, h_k, d)
    (K scaled by 3, one K row all zero: amax 0) and int32 positions."""
    quant = kv_dtype != torch.bfloat16
    shape = (n_pages + 1, h_k, page, d)
    pools = [torch.zeros(shape, dtype=kv_dtype, device="cuda") for _ in range(2)]
    if quant:
        pools += [torch.zeros(shape[:-1], device="cuda") for _ in range(2)]
    per = n_pages // b
    perm = torch.randperm(n_pages, generator=gen, device="cuda").int()
    bt = torch.full((b, max_pages), n_pages, dtype=torch.int32, device="cuda")
    for i in range(b):
        bt[i, :min(per, max_pages)] = perm[i * per: i * per + min(per, max_pages)]
    kn = (torch.randn((b, sq, h_k, d), generator=gen, device="cuda") * 3).bfloat16()
    vn = torch.randn((b, sq, h_k, d), generator=gen, device="cuda").bfloat16()
    kn[0, 0, 0] = 0
    pos = torch.tensor(positions, dtype=torch.int32, device="cuda")
    return pools, bt, kn, vn, pos


def append_equal(pools, ref, n_pages) -> bool:
    """Pools and scales bit-equal to the plain version's off the trash page."""
    return all(torch.equal(a[:n_pages].view(torch.uint8), w[:n_pages].view(torch.uint8))
               for a, w in zip(pools, ref))


# the append kernel's widths beyond the serving shapes: (name, kv dtype, b,
# sq, h_k, d, page, n_pages, max_pages, positions). d = 64 takes a half-warp
# a row, d = 32 a quarter of the lanes of one, d = 192 two chunks a lane,
# d = 40 and 66 the scalar loop (rows not 8-byte multiples); the chunks cross
# page boundaries and run past the block table.
APPEND_WIDTH_CASES = [
    (f"d64_{str(dt).split('.')[-1]}", dt, 2, 100, 8, 64, 32, 12, 5, [40, 100])
    for dt in (torch.float8_e4m3fn, torch.int8, torch.bfloat16)
] + [
    ("d32_int8", torch.int8, 3, 5, 2, 32, 16, 12, 4, [14, 33, 0]),
    ("d192_fp8", torch.float8_e4m3fn, 1, 70, 4, 192, 64, 4, 2, [30]),
    ("d40_fp8", torch.float8_e4m3fn, 2, 9, 2, 40, 16, 8, 4, [7, 60]),
    ("d66_int8", torch.int8, 2, 9, 3, 66, 16, 8, 4, [7, 60]),
    ("d66_bf16", torch.bfloat16, 2, 9, 3, 66, 16, 8, 4, [7, 60]),
]


def check_append_widths(gen, timer, checks, cfg):
    """The append kernel at the largest bucket (2048 rows of Llama-8B's 8
    kv heads at d = 128 into an fp8 page-256 pool, as an admission appends
    it) and at APPEND_WIDTH_CASES, each bit-equal to the plain version off
    the trash page. The bucket is timed: on the Timer, behind a read-only
    flush (Timer(clean=True)) and on device (`device_ms`)."""
    from xf_flash_attention_cutlass_tpu_torch.ops.paged_append import (
        paged_append,
        paged_append_ref,
    )

    out = None
    cases = [("bucket2048_fp8", torch.float8_e4m3fn, 1, 2048, cfg.n_kv_heads, cfg.head_dim,
              256, 16, 8, [0])] + APPEND_WIDTH_CASES
    for name, dt, b, sq, h_k, d, page, n_pages, max_pages, positions in cases:
        pools, bt, kn, vn, pos = append_case(gen, dt, b, sq, h_k, d, page, n_pages, max_pages,
                                             positions)
        ref = [t.clone() for t in pools]
        sc = dict(k_scales=pools[2], v_scales=pools[3]) if len(pools) == 4 else {}

        def kernel():
            paged_append(pools[0], pools[1], kn, vn, bt, pos, **sc)

        def plain():
            paged_append_ref(ref[0], ref[1], kn, vn, bt, pos, *ref[2:])

        kernel()
        plain()
        torch.cuda.synchronize()
        equal = append_equal(pools, ref, n_pages)
        checks.add(f"paged_append.width[{name}]", equal,
                   max_abs_err=0.0 if equal else float("nan"), tolerance=0.0,
                   criterion="bit-equal pools and scales off the trash page")
        if name.startswith("bucket"):
            rows = 2 * b * sq * h_k
            by = nbytes(kn, vn, bt, pos) + rows * (d * pools[0].element_size() + 4)
            out = dict(rows=rows, ms=timer.ms(kernel), clean_ms=Timer(clean=True).ms(kernel),
                       device_ms=device_ms(kernel, APPEND_KERNEL),
                       plain_ms=timer.ms(plain, PLAIN_REPS), bound=bound(by, 0),
                       err=0.0 if equal else float("nan"), tol=0.0)
        del pools, ref
    return out


def check_qmm(gen, timer, checks, w_dtype, m, shapes, stacked, timed=True, kind=None,
              splits=None):
    """K3 (stacked, layer_idx) / K4 (one weight) over `shapes` at m rows.
    2x rule against the f32 product, with the plain version (f32 product
    rounded to bf16) as the low-precision oracle. Times (when `timed`) are
    summed over the shapes: one layer's projections, or the lm_head; each
    shape's own are in `per_shape`. `kind` names the kernel of csrc/qmm.cu
    to run ('bm64' / 'bm16': the WMMA kernel, timed beside the wgmma /
    decode kernel on the same shapes), and `splits` its split count; by
    default the route's and its plan's."""
    from xf_flash_attention_cutlass_tpu_torch.quant.linear import (
        _qmm_cuda,
        quantize_weight,
        quantized_matmul,
        quantized_matmul_ref,
    )

    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0, ops=0)
    per_shape = []
    worst = (0.0, 1.0)
    for K, N in shapes:
        w = torch.randn((K, N), generator=gen, device="cuda") / math.sqrt(K)
        if w_dtype == torch.bfloat16:
            wq, s = w.bfloat16(), None
        else:
            wq, s = quantize_weight(w, w_dtype)
        del w
        x = torch.randn((m, K), generator=gen, device="cuda").bfloat16()
        if kind is not None or splits is not None:
            def kernel():
                return _qmm_cuda(x, wq, s, "qmm.stacked" if stacked else "qmm.single", kind,
                                 splits)
        elif stacked:
            wst = torch.stack([torch.zeros_like(wq), wq])
            sst = None if s is None else torch.stack([torch.zeros_like(s), s])

            def kernel():
                return quantized_matmul(x, wst, sst, layer_idx=1)
        else:
            def kernel():
                return quantized_matmul(x, wq, s)

        def plain():
            return quantized_matmul_ref(x, wq, s)

        y = kernel()
        y32 = x.float() @ wq.float()
        if s is not None:
            y32 = y32 * s
        err, lp = max_err(y, y32), max_err(plain(), y32)
        tol = 2 * lp + 1e-5
        route = ("qmm.stacked" if stacked else "qmm.single") + (f".{kind}" if kind else "")
        tag = f",splits={splits}" if splits is not None else ""
        checks.add(f"{route}[m={m},K={K},N={N},{str(w_dtype).split('.')[-1]}{tag}]",
                   err <= tol, max_abs_err=err, tolerance=tol)
        if err / tol >= worst[0] / worst[1]:
            worst = (err, tol)
        if not timed:
            continue
        w_deq = (wq.float() * (s if s is not None else 1.0)).bfloat16()
        one = dict(K=K, N=N, ms=timer.ms(kernel), library_ms=timer.ms(lambda: torch.matmul(x, w_deq)),
                   bound_ms=bound(nbytes(x, wq, s, y), 2 * m * K * N)[0])
        per_shape.append(one)
        tot["ms"] += one["ms"]
        tot["plain_ms"] += timer.ms(plain, PLAIN_REPS)
        tot["library_ms"] += one["library_ms"]
        tot["bytes"] += nbytes(x, wq, s, y)
        tot["ops"] += 2 * m * K * N
        del w_deq
    if not timed:
        return None
    return dict(ms=tot["ms"], plain_ms=tot["plain_ms"], library_ms=tot["library_ms"],
                bound=bound(tot["bytes"], tot["ops"]), err=worst[0], tol=worst[1],
                per_shape=per_shape)


QMM_PREFILL_M = (17, 64, 100, 255, 256, 2048)  # ragged widths, a chunk, the largest bucket
QMM_DECODE_M = (1, 8, 16)  # a chunk's last token, the engine's decode batch, N = 16


def qmm_decode_times(measured):
    """Each shape's ms on the decode kernel beside bm16's on the same inputs,
    cuBLAS bf16 and the bound, at every m timed: one layer's projections
    (stacked) and the lm_head (single)."""
    out = {}
    for where in ("stacked", "single"):
        dec, old = measured[f"qmm.{where}.decode"], measured[f"qmm.{where}.bm16"]
        for tag in ["m8"] + list(dec["other_shapes"]):
            a = dec if tag == "m8" else dec["other_shapes"][tag]
            b = old if tag == "m8" else old["other_shapes"][tag]
            out[f"{where}.{tag}"] = dict(
                ms=a["ms"], bm16_ms=b["ms"], library_ms=a["library_ms"], bound_ms=a["bound"][0],
                shapes=[dict(K=x["K"], N=x["N"], ms=x["ms"], bm16_ms=y["ms"],
                             library_ms=x["library_ms"], bound_ms=x["bound_ms"])
                        for x, y in zip(a["per_shape"], b["per_shape"])])
    return out


def qmm_host_us(gen, calls=200):
    """Host time of one K3 launch on one 4096 x 4096 int8 layer, the calls
    queued behind a spin of the card so that only the host's work is timed:
    at m = 256 the wgmma route (two tensor maps encoded, the shared-memory
    limit set) beside the WMMA kernel (neither); at m = 8 the decode route
    (two tensor maps; its splits summed inside) beside bm16 (its splits
    summed by a second launch)."""
    from xf_flash_attention_cutlass_tpu_torch.quant.linear import _qmm_cuda, quantize_weight

    wq, s = quantize_weight(torch.randn((4096, 4096), generator=gen, device="cuda"))
    out = {}
    for kind, m in (("wgmma", 256), ("bm64", 256), ("decode", 8), ("bm16", 8)):
        x = torch.randn((m, 4096), generator=gen, device="cuda").bfloat16()
        _qmm_cuda(x, wq, s, "qmm.stacked", kind)
        torch.cuda.synchronize()
        torch.cuda._sleep(40 * SLEEP_CYCLES)  # about 0.1 s: longer than the host's loop
        t0 = time.perf_counter()
        for _ in range(calls):
            _qmm_cuda(x, wq, s, "qmm.stacked", kind)
        out[kind] = 1e6 * (time.perf_counter() - t0) / calls
        torch.cuda.synchronize()
    return out


def check_qmm_conversion(checks):
    """The weight conversion of the wgmma and decode kernels, bit for bit:
    x = I (256 x 256) times a 256 x 256 int8 / e4m3 weight holding every
    byte value in every column (e4m3's two NaN codes excepted), with no
    scale, gives the weight itself, since every int8 and e4m3 value is a
    bf16 value (e4m3's subnormals included). The decode kernel takes the
    identity in slices of 16 rows (its N = 16) and of 8 (N = 8): 16 or 32
    calls that together cover every row of the weight, so every byte value."""
    from xf_flash_attention_cutlass_tpu_torch.quant.linear import qmm_route, quantized_matmul

    x = torch.eye(256, device="cuda", dtype=torch.bfloat16)
    codes = torch.arange(256, device="cuda", dtype=torch.int32)
    w_bytes = torch.stack([(codes + 37 * n) % 256 for n in range(256)], dim=1).to(torch.uint8)
    for w_dtype in (torch.int8, torch.float8_e4m3fn):
        w = w_bytes.view(w_dtype)
        if w_dtype == torch.float8_e4m3fn:  # 0x7f and 0xff are NaN
            w = torch.where((w_bytes & 0x7F) == 0x7F, torch.zeros_like(w_bytes), w_bytes
                            ).view(w_dtype)
        want = w.float().bfloat16()
        name = str(w_dtype).split('.')[-1]
        route = qmm_route(256, 256, 256, w_dtype, x.data_ptr(), w.data_ptr())
        y = quantized_matmul(x, w, None)
        # by value: e4m3's -0 comes out +0, a sum of +0 products
        equal = route == "wgmma" and torch.equal(y.float(), want.float())
        checks.add(f"qmm.conversion_exact[{name}]", equal, route=route,
                   mismatches=int((y.float() != want.float()).sum()))
        for rows in (16, 8):
            routes = {qmm_route(rows, 256, 256, w_dtype, x[i:i + rows].data_ptr(), w.data_ptr())
                      for i in range(0, 256, rows)}
            y = torch.cat([quantized_matmul(x[i:i + rows], w, None) for i in range(0, 256, rows)])
            equal = routes == {"decode"} and torch.equal(y.float(), want.float())
            checks.add(f"qmm.decode.conversion_exact[{name},n={rows}]", equal,
                       routes=sorted(routes), mismatches=int((y.float() != want.float()).sum()))


def check_qmm_decode_repeat(gen, checks):
    """The decode kernel's in-kernel split-K sum: at Llama-8B shapes whose
    plan splits K, two calls give the same bits, and the arrival counters
    read all zeros after them (every last split reset its tile's counter);
    and one split per k-tile (the most the plan could give) holds the 2x
    rule against the f32 product."""
    from xf_flash_attention_cutlass_tpu_torch.quant.linear import (
        _qmm_cuda,
        decode_counters,
        qmm_splits,
        quantize_weight,
        quantized_matmul,
        quantized_matmul_ref,
    )

    for m, K, N in ((8, 4096, 1024), (16, 14336, 4096), (1, 4096, 4096), (16, 4096, 1024)):
        wq, s = quantize_weight(torch.randn((K, N), generator=gen, device="cuda") / math.sqrt(K))
        x = torch.randn((m, K), generator=gen, device="cuda").bfloat16()
        splits = qmm_splits(m, N, K)[0]
        y1 = quantized_matmul(x, wq, s)
        y2 = quantized_matmul(x, wq, s)
        torch.cuda.synchronize()
        nonzero = int(decode_counters(x.device).count_nonzero())
        checks.add(f"qmm.decode_repeat[m={m},K={K},N={N}]",
                   splits > 1 and torch.equal(y1, y2) and nonzero == 0,
                   splits=splits, nonzero_counters=nonzero)
        y32 = x.float() @ wq.float() * s
        tol = 2 * max_err(quantized_matmul_ref(x, wq, s), y32) + 1e-5
        y = _qmm_cuda(x, wq, s, "qmm.single", "decode", K // 64)
        torch.cuda.synchronize()
        nonzero = int(decode_counters(x.device).count_nonzero())
        err = max_err(y, y32)
        checks.add(f"qmm.decode_every_split[m={m},K={K},N={N},splits={K // 64}]",
                   err <= tol and nonzero == 0, max_abs_err=err, tolerance=tol,
                   nonzero_counters=nonzero)


def check_other_shapes(gen, checks):
    """Shapes off the serving path that the kernels also take, checked but
    not timed: qmm at ragged m, K and N (rows TMA cannot load take the WMMA
    kernel and its element-wise loads), paged attention at page 16 and
    head_dim 64 with several row tiles, split runs and non-causal rows, and
    appends of several tokens at unaligned positions."""
    from xf_flash_attention_cutlass_tpu_torch.ops.paged import paged_attention
    from xf_flash_attention_cutlass_tpu_torch.ops.paged_append import (
        paged_append,
        paged_append_ref,
    )
    from xf_flash_attention_cutlass_tpu_torch.quant.linear import (
        quantize_weight,
        quantized_matmul,
        quantized_matmul_ref,
    )
    from xf_flash_attention_cutlass_tpu_torch.utils.testing import paged_attention_oracle

    for m, K, N, w_dtype in ((1, 200, 300, torch.int8), (5, 203, 136, torch.float8_e4m3fn),
                             (100, 4100, 1000, torch.int8), (17, 256, 130, torch.bfloat16)):
        w = torch.randn((K, N), generator=gen, device="cuda") / math.sqrt(K)
        wq, s = (w.bfloat16(), None) if w_dtype == torch.bfloat16 else quantize_weight(w, w_dtype)
        x = torch.randn((m, K), generator=gen, device="cuda").bfloat16()
        y32 = x.float() @ wq.float() * (1.0 if s is None else s)
        lp = max_err(quantized_matmul_ref(x, wq, s), y32)
        for stacked in (False, True):
            y = (quantized_matmul(x, torch.stack([wq, wq]), None if s is None else
                                  torch.stack([s, s]), layer_idx=1)
                 if stacked else quantized_matmul(x, wq, s))
            err = max_err(y, y32)
            checks.add(f"other.qmm[m={m},K={K},N={N},{str(w_dtype).split('.')[-1]},"
                       f"stacked={stacked}]", err <= 2 * lp + 1e-5,
                       max_abs_err=err, tolerance=2 * lp + 1e-5)
    # decode width on an x that TMA cannot load (its base 2 bytes off 16):
    # the bm16 kernel
    from xf_flash_attention_cutlass_tpu_torch import _build

    wq, s = quantize_weight(torch.randn((4096, 1024), generator=gen, device="cuda") / 64)
    x = torch.randn(8 * 4096 + 1, generator=gen, device="cuda").bfloat16()[1:].view(8, 4096)
    y32 = x.float() @ wq.float() * s
    tol = 2 * max_err(quantized_matmul_ref(x, wq, s), y32) + 1e-5
    before = _build.LAUNCHES["qmm.single.bm16"]
    err = max_err(quantized_matmul(x, wq, s), y32)
    checks.add("other.qmm[m=8,K=4096,N=1024,int8,x_misaligned]",
               err <= tol and _build.LAUNCHES["qmm.single.bm16"] == before + 1,
               max_abs_err=err, tolerance=tol)

    h, h_k, d, page, n_pages, max_pages = 8, 2, 64, 16, 40, 12
    for kv_dtype, b, sq, causal, splits in ((torch.bfloat16, 3, 5, True, 3),
                                             (torch.int8, 2, 40, True, 2),
                                             (torch.float8_e4m3fn, 3, 1, True, 0),
                                             (torch.bfloat16, 2, 7, False, 1)):
        kp, vp, ks, vs = kv_pools(gen, kv_dtype, 1, n_pages, h_k, page, d)
        kp, vp = kp[0], vp[0]
        sc = {} if ks is None else dict(k_scales=ks[0], v_scales=vs[0])
        bt = torch.stack([torch.randperm(n_pages, generator=gen, device="cuda")[:max_pages]
                          for _ in range(b)]).int()
        lens = torch.randint(sq, max_pages * page + 1, (b,), generator=gen, device="cuda").int()
        lens[-1] = 0
        bt[-1] = n_pages
        q = torch.randn((b, sq, h, d), generator=gen, device="cuda").bfloat16()
        o, lse = paged_attention(q, kp, vp, bt, lens, causal=causal, num_splits=splits, **sc)
        o32, _ = paged_attention_oracle(q, kp, vp, bt, lens, causal=causal, **sc)
        olp, _ = paged_attention_oracle(q, kp, vp, bt, lens, causal=causal, upcast=False, **sc)
        live = lens > 0
        err, tol = max_err(o, o32), 2 * max_err(olp, o32) + 1e-5
        dead_ok = bool((o[~live] == 0).all()) and bool(torch.isneginf(lse[~live]).all())
        finite = bool(torch.isfinite(o).all()) and bool(torch.isfinite(lse[live]).all())
        checks.add(f"other.paged_attention[{str(kv_dtype).split('.')[-1]},b={b},sq={sq},"
                   f"causal={causal},splits={splits}]", err <= tol and dead_ok and finite,
                   max_abs_err=err, tolerance=tol, dead_rows_ok=dead_ok)

    for kv_dtype in (torch.int8, torch.float8_e4m3fn, torch.bfloat16):
        b, sq = 3, 5
        shape = (n_pages + 1, h_k, page, d)
        pools = [torch.zeros(shape, dtype=kv_dtype, device="cuda") for _ in range(2)]
        if kv_dtype != torch.bfloat16:
            pools += [torch.zeros(shape[:-1], device="cuda") for _ in range(2)]
        ref = [t.clone() for t in pools]
        bt = torch.randperm(n_pages, generator=gen, device="cuda")[:b * 4].int().reshape(b, 4)
        pos = torch.tensor([14, 33, 0], dtype=torch.int32, device="cuda")
        kn = (torch.randn((b, sq, h_k, d), generator=gen, device="cuda") * 3).bfloat16()
        vn = torch.randn((b, sq, h_k, d), generator=gen, device="cuda").bfloat16()
        sc = dict(k_scales=pools[2], v_scales=pools[3]) if len(pools) == 4 else {}
        paged_append(pools[0], pools[1], kn, vn, bt, pos, **sc)
        paged_append_ref(ref[0], ref[1], kn, vn, bt, pos, *ref[2:])
        equal = all(torch.equal(a[:n_pages].view(torch.uint8), w[:n_pages].view(torch.uint8))
                    for a, w in zip(pools, ref))
        checks.add(f"other.paged_append[{str(kv_dtype).split('.')[-1]},page={page},sq={sq}]",
                   equal, max_abs_err=0.0 if equal else float("nan"), tolerance=0.0)


# K1's routes off the engine's shapes: (kv dtype, h, h_k, d, page, b, sq,
# causal, num_splits, layers, options, route the call must take, largest
# kv_len or None for the table's). The Hopper chunk kernel at page 16, 24
# (8-key TMA boxes), 32, 64 and 256, d = 64 and 128, one split and several
# (0: the heuristic), causal and not, a layer of a stacked pool, rows not a
# multiple of 64 and one row tile of 17 rows; the decode kernel at groups 1,
# 4 and 8, sq 1-4 (4-16 rows), pages 16-256, d 64 and 128, splits 1, 3, the
# heuristic's and more than the live tiles, a stacked layer, kv_len < 64 and
# non-causal rows; each Hopper kernel with an option (its options
# instantiation); the WMMA kernel where the route sends it, odd pages, with
# and without an option, at chunk and at decode sizes.
PAGED_ROUTE_CASES = [
    (torch.float8_e4m3fn, 8, 2, 64, 16, 3, 40, True, 2, 1, {}, "wgmma", None),
    (torch.int8, 8, 2, 128, 32, 2, 24, True, 1, 2, {}, "wgmma", None),
    (torch.bfloat16, 8, 2, 128, 64, 2, 20, False, 3, 1, {}, "wgmma", None),
    (torch.bfloat16, 8, 2, 64, 256, 2, 33, True, 0, 2, {}, "wgmma", None),
    (torch.float8_e4m3fn, 4, 4, 128, 256, 2, 17, False, 2, 1, {}, "wgmma", None),
    (torch.int8, 8, 2, 128, 24, 2, 30, True, 1, 1, {}, "wgmma", None),
    (torch.bfloat16, 32, 8, 128, 16, 2, 8, True, 4, 1, {}, "wgmma", None),
    (torch.float8_e4m3fn, 8, 2, 128, 64, 2, 100, True, 0, 1, {}, "wgmma", None),
    (torch.bfloat16, 8, 2, 128, 64, 2, 20, True, 1, 1, dict(softcap=20.0), "wgmma", None),
    (torch.int8, 8, 2, 64, 12, 2, 20, True, 1, 1, {}, "wmma", None),
    (torch.float8_e4m3fn, 32, 8, 128, 32, 3, 1, True, 0, 1, {}, "decode", None),
    (torch.bfloat16, 8, 8, 64, 16, 3, 2, True, 3, 2, {}, "decode", None),
    (torch.int8, 16, 2, 128, 64, 2, 2, True, 1, 1, {}, "decode", None),
    (torch.float8_e4m3fn, 8, 2, 64, 256, 3, 4, True, 20, 2, {}, "decode", 200),
    (torch.bfloat16, 32, 8, 128, 256, 2, 1, False, 3, 1, {}, "decode", 60),
    (torch.int8, 8, 2, 128, 16, 3, 3, True, 0, 1, {}, "decode", None),
    (torch.float8_e4m3fn, 32, 8, 128, 32, 3, 1, True, 0, 1, dict(softcap=20.0), "decode", None),
    (torch.bfloat16, 8, 2, 64, 12, 2, 1, True, 1, 1, {}, "wmma", None),
    (torch.int8, 8, 2, 128, 12, 2, 20, True, 1, 1, dict(softcap=20.0), "wmma", None),
    (torch.float8_e4m3fn, 32, 8, 128, 12, 3, 1, True, 0, 1, dict(window=(40, 0)), "wmma", None),
]


def check_paged_route_shapes(gen, checks):
    """K1 on PAGED_ROUTE_CASES, untimed: each call must launch the route
    paged_plan names, and pass the 2x rule against both its plain version
    and the f32 oracle, with every row of the last batch entry dead (kv_len
    0: O = 0, LSE = -inf)."""
    from xf_flash_attention_cutlass_tpu_torch import _build
    from xf_flash_attention_cutlass_tpu_torch.ops.paged import (
        has_options,
        paged_attention,
        paged_attention_ref,
        paged_plan,
        route_label,
    )
    from xf_flash_attention_cutlass_tpu_torch.utils.testing import paged_attention_oracle

    n_pages, max_pages = 40, 12
    for (kv_dtype, h, h_k, d, page, b, sq, causal, splits, layers, opts, want,
         max_len) in PAGED_ROUTE_CASES:
        kp, vp, ks, vs = kv_pools(gen, kv_dtype, layers, n_pages, h_k, page, d)
        layer = layers - 1
        sc = {} if ks is None else dict(k_scales=ks, v_scales=vs)
        sc1 = {} if ks is None else dict(k_scales=ks[layer], v_scales=vs[layer])
        bt = torch.stack([torch.randperm(n_pages, generator=gen, device="cuda")[:max_pages]
                          for _ in range(b)]).int()
        lens = torch.randint(sq, (max_len or max_pages * page) + 1, (b,), generator=gen,
                             device="cuda").int()
        lens[-1] = 0
        bt[-1] = n_pages
        q = torch.randn((b, sq, h, d), generator=gen, device="cuda").bfloat16()
        kw = dict(causal=causal, **opts)
        route, n_splits = paged_plan(q.shape, kp.shape, kv_dtype, max_pages, splits, **kw)
        full = dict(window=(-1, -1), softcap=0.0, alibi_slopes=None, cache_leftpad=None)
        full.update(kw)
        label = route_label(route, sq * (h // h_k), has_options(**full))
        n0 = _build.LAUNCHES[label]
        o, lse = paged_attention(q, kp, vp, bt, lens, num_splits=splits, layer_idx=layer, **kw,
                                 **sc)
        launched = _build.LAUNCHES[label] - n0 == 1
        o_plain, _ = paged_attention_ref(q, kp[layer], vp[layer], bt, lens, num_splits=n_splits,
                                         **kw, **sc1)
        o32, _ = paged_attention_oracle(q, kp[layer], vp[layer], bt, lens, **kw, **sc1)
        olp, _ = paged_attention_oracle(q, kp[layer], vp[layer], bt, lens, upcast=False, **kw,
                                        **sc1)
        live = lens > 0
        err, plain_err = max_err(o, o32), max_err(o, o_plain)
        tol = 2 * max_err(olp, o32) + 1e-5
        dead_ok = bool((o[~live] == 0).all()) and bool(torch.isneginf(lse[~live]).all())
        finite = bool(torch.isfinite(o).all()) and bool(torch.isfinite(lse[live]).all())
        ok = (route == want and launched and err <= tol and plain_err <= tol and dead_ok
              and finite)
        checks.add(f"route.paged_attention[{route},{str(kv_dtype).split('.')[-1]},h={h}/{h_k},"
                   f"d={d},page={page},b={b},sq={sq},causal={causal},splits={n_splits},"
                   f"layer={layer}{',' + ','.join(opts) if opts else ''}"
                   f"{'' if max_len is None else f',max_len={max_len}'}]", ok,
                   max_abs_err=plain_err, err_vs_f32_oracle=err, tolerance=tol,
                   dead_rows_ok=dead_ok, route=route, expected_route=want, launched=launched)


def check_paged_combine(gen, timer, checks, cfg, n_splits):
    """The combine kernel against its plain version (combine_partials, then
    O in bf16 and LSE moved to (b, h, sq)) on f32 partials of K1 decode's
    caller layout at the engine's shape (b = 8, sq = 1, 32 heads, d = 128)
    and split count, with an empty partial and a row whose partials are all
    empty. Tolerance: O within one bf16 rounding of the f32 merge
    (2^-8 |O| + 1e-6 an element), LSE within 1e-5 + 1e-6 |LSE|; the empty
    row gives O = 0 and LSE = -inf."""
    from xf_flash_attention_cutlass_tpu_torch.ops.combine import combine_partials
    from xf_flash_attention_cutlass_tpu_torch.ops.paged import combine_splits, combine_splits_ref

    b, sq, h, d = 8, 1, cfg.n_heads, cfg.head_dim
    o_part = torch.randn((n_splits, b, sq, h, d), generator=gen, device="cuda")
    lse_part = 4 * torch.randn((n_splits, b, sq, h), generator=gen, device="cuda")
    lse_part[0, 0, 0, 0] = -math.inf  # an empty split
    lse_part[:, -1] = -math.inf  # an inactive slot: every split empty
    o, lse = combine_splits(o_part, lse_part, torch.bfloat16)
    o_plain, lse_plain = combine_splits_ref(o_part, lse_part, torch.bfloat16)
    o32, _ = combine_partials(o_part, lse_part)
    torch.cuda.synchronize()
    o_excess = float(((o.float() - o32).abs() - 2.0 ** -8 * o32.abs()).max())
    finite = torch.isfinite(lse_plain)
    lse_excess = float(((lse[finite] - lse_plain[finite]).abs()
                        - 1e-6 * lse_plain[finite].abs()).max())
    empty_ok = bool((o[-1] == 0).all()) and bool(torch.isneginf(lse[-1]).all())
    same_empty = torch.equal(torch.isfinite(lse), finite)
    ok = o_excess <= 1e-6 and lse_excess <= 1e-5 and empty_ok and same_empty
    err = max_err(o, o_plain)
    checks.add(f"paged_attention.combine[splits={n_splits}]", ok, max_abs_err=err,
               o_excess_over_one_bf16_rounding=o_excess, lse_excess=lse_excess,
               empty_rows_ok=empty_ok)
    # bound: the partials read once, O (bf16) and LSE written once
    by = nbytes(o_part, lse_part) + b * sq * h * (2 * d + 4)
    return dict(ms=timer.ms(lambda: combine_splits(o_part, lse_part, torch.bfloat16)),
                plain_ms=timer.ms(lambda: combine_splits_ref(o_part, lse_part, torch.bfloat16),
                                  PLAIN_REPS),
                library_ms=None, bound=bound(by, 0), err=err,
                tol=float(2.0 ** -7 * o32.abs().max()), splits=n_splits)


def check_bucket_append(gen, checks, cfg):
    """K5 as bucketed prefill drives it: a prompt padded to its bucket
    (256-2048 tokens, the serving prompts' buckets) appended whole at
    position 0 into an FP8 pool of page 256, through a block-table row
    that holds the prompt's pages and then the trash page, as
    DecodeEngine._admit_one builds it. Bit-equal to the plain version off
    the trash page."""
    from xf_flash_attention_cutlass_tpu_torch.ops.paged_append import (
        paged_append,
        paged_append_ref,
    )

    h_k, d, page, n_pages = cfg.n_kv_heads, cfg.head_dim, 256, 32
    for true_len, bucket in ((253, 256), (297, 512), (864, 1024), (1306, 2048)):
        shape = (2, n_pages + 1, h_k, page, d)
        pools = [torch.zeros(shape, dtype=torch.float8_e4m3fn, device="cuda") for _ in range(2)]
        pools += [torch.zeros(shape[:-1], device="cuda") for _ in range(2)]
        ref = [t[1].clone() for t in pools]
        live = -(-true_len // page)
        bt_row = torch.full((1, bucket // page), n_pages, dtype=torch.int32, device="cuda")
        bt_row[0, :live] = torch.randperm(n_pages, generator=gen, device="cuda")[:live].int()
        pos = torch.zeros(1, dtype=torch.int32, device="cuda")
        kn = (torch.randn((1, bucket, h_k, d), generator=gen, device="cuda") * 3).bfloat16()
        vn = torch.randn((1, bucket, h_k, d), generator=gen, device="cuda").bfloat16()
        paged_append(pools[0], pools[1], kn, vn, bt_row, pos, layer_idx=1,
                     k_scales=pools[2], v_scales=pools[3])
        paged_append_ref(ref[0], ref[1], kn, vn, bt_row, pos, ref[2], ref[3])
        torch.cuda.synchronize()
        equal = all(torch.equal(a[1, :n_pages].view(torch.uint8), w[:n_pages].view(torch.uint8))
                    for a, w in zip(pools, ref))
        checks.add(f"paged_append.bucket[float8_e4m3fn,len={true_len},sq={bucket}]", equal,
                   max_abs_err=0.0 if equal else float("nan"), tolerance=0.0,
                   criterion="bit-equal pools and scales off the trash page")
        del pools, ref


def check_page32_append(gen, timer, checks, cfg):
    """The work of the TPU's K6 (`_scale_write_kernel`, whole per-page scale
    planes for quantized prefill into page-32 pools) done by the port's one
    append kernel: two 64-token rows at page-aligned positions into int8 and
    fp8 pools of page 32, bit-equal to the plain version off the trash page.
    The fp8 case is timed."""
    from xf_flash_attention_cutlass_tpu_torch.ops.paged_append import (
        paged_append,
        paged_append_ref,
    )

    h_k, d, page, n_pages, b, sq = cfg.n_kv_heads, cfg.head_dim, 32, 16, 2, 64
    out = None
    for kv_dtype in (torch.int8, torch.float8_e4m3fn):
        shape = (n_pages + 1, h_k, page, d)
        pools = [torch.zeros(shape, dtype=kv_dtype, device="cuda") for _ in range(2)]
        pools += [torch.zeros(shape[:-1], device="cuda") for _ in range(2)]
        ref = [t.clone() for t in pools]
        bt = torch.full((b, 4), n_pages, dtype=torch.int32, device="cuda")
        bt[:, :3] = torch.randperm(n_pages, generator=gen, device="cuda")[:6].int().reshape(b, 3)
        pos = torch.tensor([32, 0], dtype=torch.int32, device="cuda")
        kn = (torch.randn((b, sq, h_k, d), generator=gen, device="cuda") * 3).bfloat16()
        vn = torch.randn((b, sq, h_k, d), generator=gen, device="cuda").bfloat16()

        def kernel():
            paged_append(pools[0], pools[1], kn, vn, bt, pos, k_scales=pools[2],
                         v_scales=pools[3])

        def plain():
            paged_append_ref(ref[0], ref[1], kn, vn, bt, pos, ref[2], ref[3])

        kernel()
        plain()
        torch.cuda.synchronize()
        equal = all(torch.equal(a[:n_pages].view(torch.uint8), w[:n_pages].view(torch.uint8))
                    for a, w in zip(pools, ref))
        checks.add(f"paged_append.page32[{str(kv_dtype).split('.')[-1]},sq={sq}]", equal,
                   max_abs_err=0.0 if equal else float("nan"), tolerance=0.0,
                   criterion="bit-equal pools and scales off the trash page")
        if kv_dtype == torch.float8_e4m3fn:
            by = nbytes(kn, vn, bt, pos) + 2 * b * sq * h_k * (d + 4)
            out = dict(ms=timer.ms(kernel), plain_ms=timer.ms(plain, PLAIN_REPS),
                       library_ms=None, bound=bound(by, 0), err=0.0 if equal else float("nan"),
                       tol=0.0)
    return out


# ---- phase 2: dense flash attention (K7, K9, K10, K11) ------------------------

def flash_case(gen, b, h, h_k, sq, sk, d, opts):
    """q, k, v, dO (BHSD) in opts' dtype (bf16 by default) and the mask
    keywords: opts may hold causal, window, softcap, kv_lens (a list) and
    segments (True: two segments per row, and one query row whose segment no
    key has)."""
    dt = opts.get("dtype", torch.bfloat16)
    q, k, v, do = (torch.randn(s, generator=gen, device="cuda").to(dt)
                   for s in ((b, h, sq, d), (b, h_k, sk, d), (b, h_k, sk, d), (b, h, sq, d)))
    kw = {n: x for n, x in opts.items() if n not in ("kv_lens", "segments", "dtype")}
    if "kv_lens" in opts:
        kw["kv_lens"] = torch.tensor(opts["kv_lens"], dtype=torch.int32, device="cuda")
    if opts.get("segments"):
        qs = (torch.arange(sq, device="cuda") >= sq // 2).int()[None].repeat(b, 1)
        qs[0, 3] = 5
        kw["q_segment_ids"] = qs
        kw["kv_segment_ids"] = (torch.arange(sk, device="cuda") >= sk // 3).int()[None].repeat(b, 1)
    return (q, k, v, do), kw


def visible_pairs(b, h, sq, sk, kw) -> int:
    """(query, key) pairs the masks leave, over all heads: the work the
    kernels must do on these inputs."""
    from xf_flash_attention_cutlass_tpu_torch.ops.flash_fwd import attention_mask

    mask_kw = {n: x for n, x in kw.items() if n != "softcap"}
    return h * int(attention_mask(b, sq, sk, "cuda", **mask_kw).expand(b, 1, sq, sk).sum())


def check_flash_fwd_inputs(checks, name, q, k, v, kw, oracle_kw=None):
    """K7 on given inputs and options against its plain version and the
    dense f32 oracle (utils/testing.py) under the 2x rule: twice the
    low-precision oracle's error plus 1e-5, for O and for LSE; rows that see
    no key give O = 0 and LSE = -inf. oracle_kw: the oracle's options where
    they differ from the kernel's (the dropout mask). Returns (error,
    tolerance)."""
    from xf_flash_attention_cutlass_tpu_torch.ops.flash_fwd import flash_fwd, flash_fwd_ref
    from xf_flash_attention_cutlass_tpu_torch.utils.testing import flash_attention_oracle

    oracle_kw = kw if oracle_kw is None else oracle_kw
    o, lse = flash_fwd(q, k, v, **kw)
    o_plain, lse_plain = flash_fwd_ref(q, k, v, **kw)
    plain_err = max_err(o, o_plain)
    del o_plain  # the planes of the plain version and the oracles are large
    o32, l32 = flash_attention_oracle(q, k, v, **oracle_kw)
    err = max_err(o, o32)
    olp, llp = flash_attention_oracle(q, k, v, upcast=False, **oracle_kw)
    torch.cuda.synchronize()
    live = torch.isfinite(l32)
    tol, ltol = 2 * max_err(olp, o32) + 1e-5, 2 * max_err(llp[live], l32[live]) + 1e-5
    lerr, lplain = max_err(lse[live], l32[live]), max_err(lse[live], lse_plain[live])
    empty_ok = bool((o[~live] == 0).all() and torch.isneginf(lse[~live]).all())
    ok = (bool(torch.isfinite(o).all()) and empty_ok and err <= tol and plain_err <= tol
          and lerr <= ltol and lplain <= ltol)
    checks.add(f"flash_fwd.{name}", ok, max_abs_err=plain_err, tolerance=tol,
               err_vs_f32_oracle=err, lse_err=lplain, lse_err_vs_f32_oracle=lerr,
               lse_tolerance=ltol, empty_rows=int((~live).sum()), empty_rows_ok=empty_ok)
    return plain_err, tol


def check_flash_bwd_inputs(checks, name, tensors, kw, oracle_kw=None):
    """K9 + K10 (two-pass) and K11 (fused) on given inputs and options
    against the plain version and the gradients of the dense oracle under
    the 3x rule: three times the low-precision oracle's error plus 1e-4, for
    dq, dk and dv (oracle_kw: the oracle's options where they differ, the
    dropout mask). The residuals O and LSE come from the plain forward.
    Returns them and the worst (error, tolerance) of each route."""
    from xf_flash_attention_cutlass_tpu_torch.ops.flash_bwd import flash_bwd, flash_bwd_ref
    from xf_flash_attention_cutlass_tpu_torch.ops.flash_fwd import flash_fwd_ref
    from xf_flash_attention_cutlass_tpu_torch.utils.testing import flash_attention_oracle

    q, k, v, do = tensors
    oracle_kw = kw if oracle_kw is None else oracle_kw
    o, lse = flash_fwd_ref(q, k, v, **kw)

    def oracle_grads(upcast):
        xs = [(t.float() if upcast else t).detach().requires_grad_(True) for t in (q, k, v)]
        out, _ = flash_attention_oracle(*xs, upcast=upcast, **oracle_kw)
        return torch.autograd.grad((out.float() * do.float()).sum(), xs)

    g32, glp = oracle_grads(True), oracle_grads(False)
    plain = flash_bwd_ref(q, k, v, o, lse, do, **kw)
    worst = {}
    for route, fused in (("two_pass", None), ("fused", True)):
        got = flash_bwd(q, k, v, o, lse, do, fused=fused, **kw)
        torch.cuda.synchronize()
        res = {}
        for gname, x, x32, xlp, xp in zip(("dq", "dk", "dv"), got, g32, glp, plain):
            gtol = 3 * max_err(xlp, x32) + 1e-4
            res[gname] = (max_err(x, xp), max_err(x, x32), gtol)
        checks.add(f"flash_bwd.{route}.{name}", all(bool(torch.isfinite(x).all()) for x in got)
                   and all(pe <= t and e <= t for pe, e, t in res.values()),
                   **{f"{g}_err": r[0] for g, r in res.items()},
                   **{f"{g}_err_vs_f32_oracle": r[1] for g, r in res.items()},
                   **{f"{g}_tolerance": r[2] for g, r in res.items()})
        worst[route] = max(((r[0], r[2]) for r in res.values()), key=lambda t: t[0] / t[1])
    return o, lse, worst


def check_flash_fwd(gen, checks, name, b, h, h_k, sq, sk, d, opts):
    """K7 on flash_case's inputs (check_flash_fwd_inputs). Returns the
    inputs and the case's error and tolerance."""
    (q, k, v, _), kw = flash_case(gen, b, h, h_k, sq, sk, d, opts)
    err, tol = check_flash_fwd_inputs(checks, name, q, k, v, kw)
    return (q, k, v), kw, err, tol


def time_flash_fwd(timer, q, k, v, kw, err, tol):
    """Times of K7, its plain version and SDPA (causal forward over the
    group-expanded heads, a yardstick only); the bound counts the visible
    pairs: 4 d operations each, at the bf16 tensor-core peak."""
    from xf_flash_attention_cutlass_tpu_torch.ops.flash_fwd import flash_fwd, flash_fwd_ref

    b, h, sq, d = q.shape
    g = h // k.shape[1]
    kx, vx = k.repeat_interleave(g, dim=1), v.repeat_interleave(g, dim=1)
    o, lse = flash_fwd(q, k, v, **kw)
    by = nbytes(q, k, v, o, lse, kw.get("kv_lens"))
    ops = 4 * d * visible_pairs(b, h, sq, k.shape[2], kw)
    zero = torch.zeros(h, device="cuda")  # ALiBi of slope 0: the options' kernel, same result
    return dict(
        ms=timer.ms(lambda: flash_fwd(q, k, v, **kw)),
        ms_general=timer.ms(lambda: flash_fwd(q, k, v, alibi_slopes=zero, **kw)),
        plain_ms=timer.ms(lambda: flash_fwd_ref(q, k, v, **kw), PLAIN_REPS),
        library_ms=timer.ms(lambda: F.scaled_dot_product_attention(q, kx, vx, is_causal=True)),
        bound=bound(by, ops), err=err, tol=tol,
    )


def check_flash_bwd(gen, checks, name, b, h, h_k, sq, sk, d, opts):
    """K9 + K10 and K11 on flash_case's inputs (check_flash_bwd_inputs).
    Returns the inputs, the residuals and the worst (error, tolerance) of
    each route."""
    (q, k, v, do), kw = flash_case(gen, b, h, h_k, sq, sk, d, opts)
    o, lse, worst = check_flash_bwd_inputs(checks, name, (q, k, v, do), kw)
    return (q, k, v, o, lse, do), kw, worst


def bwd_launch_kw(kw, d):
    """FlashBwdLaunch's keywords for flash_case's mask keywords (no options)."""
    return dict(scale=1.0 / math.sqrt(d), causal=kw.get("causal", False),
                window=kw.get("window", (-1, -1)), softcap=kw.get("softcap", 0.0),
                kv_lens=kw.get("kv_lens"), q_segment_ids=kw.get("q_segment_ids"),
                kv_segment_ids=kw.get("kv_segment_ids"))


def check_flash_bwd_repeat(checks, tensors, kw, name):
    """K9 twice on the same inputs gives the same dQ bit for bit (no atomics:
    a block sums its rows' dQ in registers); K10 twice the same dK and dV
    (the warpgroups' sums are added in a fixed order); K11's dK and
    dV equal K10's bit for bit (the same products); K11's dQ, summed by f32
    atomics in a changing order, agrees with K9's within two bf16 ulps of the
    largest |dQ| (the atomics' order, and K9's exp against K11's exp2 in the
    recompute)."""
    from xf_flash_attention_cutlass_tpu_torch.ops.flash_bwd import FlashBwdLaunch

    q, k, v, o, lse, do = tensors
    run = FlashBwdLaunch(q, k, v, o, lse, do, **bwd_launch_kw(kw, q.shape[-1]))
    (dk1, dv1), (dk2, dv2) = run.dkv(), run.dkv()
    dq9, dq9_again = run.dq(), run.dq()
    dq11, dk11, dv11 = run.fused()
    torch.cuda.synchronize()
    checks.add(f"flash_bwd.dq_bit_reproducible[{name}]", bool(torch.equal(dq9, dq9_again)),
               max_abs_err=max_err(dq9, dq9_again), tolerance=0.0)
    same = bool(torch.equal(dk1, dk2) and torch.equal(dv1, dv2))
    checks.add(f"flash_bwd.dkv_bit_reproducible[{name}]", same,
               max_abs_err=max(max_err(dk1, dk2), max_err(dv1, dv2)), tolerance=0.0)
    same11 = bool(torch.equal(dk11, dk1) and torch.equal(dv11, dv1))
    checks.add(f"flash_bwd.fused_dkv_equals_dkv[{name}]", same11,
               max_abs_err=max(max_err(dk11, dk1), max_err(dv11, dv1)), tolerance=0.0)
    err, tol = max_err(dq11, dq9), float(dq9.float().abs().max()) / 128
    checks.add(f"flash_bwd.fused_dq_vs_dq[{name}]", err <= tol, max_abs_err=err, tolerance=tol,
               criterion="two bf16 ulps of the largest |dQ|")


def time_flash_bwd(timer, tensors, kw, worst):
    """Times of K9, K10 and K11 (each launched alone on prepared inputs),
    the plain backward and SDPA's backward (autograd through a causal SDPA
    over the group-expanded heads, a yardstick only; SDPA's forward plus
    backward is timed beside it, as `library_fwd_bwd_ms`). Bounds in operations:
    2 d per visible pair for each tile product, K9 three products (S, dP,
    dQ), K10 four (S, dP, dK, dV), K11 five."""
    from xf_flash_attention_cutlass_tpu_torch.ops.flash_bwd import FlashBwdLaunch, flash_bwd_ref

    q, k, v, o, lse, do = tensors
    b, h, sq, d = q.shape
    launch_kw = bwd_launch_kw(kw, d)
    run = FlashBwdLaunch(q, k, v, o, lse, do, **launch_kw)
    # ALiBi of slope 0: the options' kernels on the same work, same result
    run_general = FlashBwdLaunch(q, k, v, o, lse, do, alibi_slopes=torch.zeros(h, device="cuda"),
                                 **launch_kw)
    pair_ops = 2 * d * visible_pairs(b, h, sq, k.shape[2], kw)
    plain_ms = timer.ms(lambda: flash_bwd_ref(q, k, v, o, lse, do, **kw), PLAIN_REPS)
    g = h // k.shape[1]
    qx = q.detach().requires_grad_(True)
    kx, vx = (t.detach().requires_grad_(True) for t in (k, v))
    sdpa_out = F.scaled_dot_product_attention(qx, kx.repeat_interleave(g, dim=1),
                                              vx.repeat_interleave(g, dim=1), is_causal=True)
    library_ms = timer.ms(
        lambda: torch.autograd.grad(sdpa_out, (qx, kx, vx), do, retain_graph=True))

    def sdpa_fwd_bwd():
        out = F.scaled_dot_product_attention(qx, kx.repeat_interleave(g, dim=1),
                                             vx.repeat_interleave(g, dim=1), is_causal=True)
        return torch.autograd.grad(out, (qx, kx, vx), do)

    library_fwd_bwd_ms = timer.ms(sdpa_fwd_bwd)
    ins = nbytes(q, k, v, do, lse) + 4 * lse.numel()  # and Delta (f32, like LSE)
    dq, (dk, dv) = run.dq(), run.dkv()
    out = {}
    for key, fn, n_prod, outs, route in (
            ("flash_bwd.dq", "dq", 3, (dq,), "two_pass"),
            ("flash_bwd.dkv", "dkv", 4, (dk, dv), "two_pass"),
            ("flash_bwd.fused", "fused", 5, (dq, dk, dv), "fused")):
        out[key] = dict(ms=timer.ms(getattr(run, fn)),
                        ms_general=timer.ms(getattr(run_general, fn)),
                        plain_ms=plain_ms, library_ms=library_ms,
                        library_fwd_bwd_ms=library_fwd_bwd_ms,
                        bound=bound(ins + nbytes(*outs), n_prod * pair_ops),
                        err=worst[route][0], tol=worst[route][1])
    return out


FLASH_OFF_PATH = [  # (name, b, h, h_k, sq, sk, d, options): untimed
    ("unaligned_113x203", 2, 4, 2, 113, 203, 128, dict()),
    ("unaligned_causal_113x203", 2, 4, 2, 113, 203, 128, dict(causal=True)),
    ("d64", 2, 4, 2, 160, 160, 64, dict(causal=True)),
    ("window", 1, 4, 2, 200, 200, 128, dict(window=(48, 16))),
    ("softcap", 1, 4, 2, 150, 150, 128, dict(causal=True, softcap=30.0)),
    ("segments", 2, 4, 2, 130, 130, 128, dict(causal=True, segments=True)),
    ("gqa_4_1", 1, 8, 2, 256, 256, 128, dict(causal=True)),
    ("kv_lens_empty_row", 2, 4, 2, 96, 96, 128, dict(causal=True, kv_lens=[50, 0])),
]


# K7 where its tiling can break it (64-row blocks, 64-key tiles, the
# per-entry mask on boundary tiles only): untimed, forward only
FLASH_FWD_TILING = [  # (name, b, h, h_k, sq, sk, d, options)
    ("sq1_sk50", 1, 8, 2, 1, 50, 128, dict()),
    ("sq1_causal_sk700", 1, 32, 8, 1, 700, 128, dict(causal=True)),
    ("sk_below_tile_40x33_causal", 2, 4, 2, 40, 33, 128, dict(causal=True)),
    ("ragged_300x1000_causal", 1, 8, 2, 300, 1000, 128, dict(causal=True)),
    ("ragged_1000x300", 1, 8, 2, 1000, 300, 128, dict()),
    ("kv_lens_in_tile", 2, 8, 2, 256, 256, 128, dict(causal=True, kv_lens=[100, 37])),
    ("window_edge_in_tile", 1, 8, 2, 512, 512, 128, dict(window=(100, 30))),
    ("window_left_causal_in_tile", 1, 8, 2, 384, 384, 128, dict(causal=True, window=(77, -1))),
    ("gqa_4_1_bucket256", 1, 32, 8, 256, 256, 128, dict(causal=True)),
    ("segments_ragged", 2, 8, 2, 200, 200, 128, dict(causal=True, segments=True)),
    ("softcap_ragged", 1, 8, 2, 130, 190, 128, dict(causal=True, softcap=30.0)),
    ("fp16_d64", 2, 8, 2, 300, 300, 64, dict(causal=True, dtype=torch.float16)),
    ("fp16_d64_window", 1, 8, 2, 333, 333, 64, dict(window=(64, 64), dtype=torch.float16)),
    ("fp16_d128_kv_lens", 1, 8, 2, 200, 200, 128,
     dict(causal=True, kv_lens=[150], dtype=torch.float16)),
    ("bf16_d64_gqa", 1, 16, 4, 700, 700, 64, dict(causal=True)),
]


def check_flash_fwd_tiling(gen, checks, cfg):
    """K7 on FLASH_FWD_TILING under the 2x rule; then q, k, v as the (b, s, h, d)
    views the model passes, at the training shape, against contiguous
    copies of them, bit for bit, and the kernels one K7 call on those views
    launches (a profiler trace): flash_fwd_kernel alone, no copy and no
    scale pass. Returns the names of the kernels of that call."""
    from xf_flash_attention_cutlass_tpu_torch.ops.flash_fwd import flash_fwd

    for name, *shape, opts in FLASH_FWD_TILING:
        check_flash_fwd(gen, checks, f"tiling.{name}", *shape, opts)
    h, h_k, d, s = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, 1024
    views = [torch.randn(sh, generator=gen, device="cuda").bfloat16().transpose(1, 2)
             for sh in ((1, s, h, d), (1, s, h_k, d), (1, s, h_k, d))]
    kw = dict(causal=True, kv_lens=torch.tensor([900], dtype=torch.int32, device="cuda"))
    o1, l1 = flash_fwd(*views, **kw)
    o2, l2 = flash_fwd(*(t.contiguous() for t in views), **kw)
    checks.add("flash_fwd.bshd_views_same_result",
               bool(torch.equal(o1, o2) and torch.equal(l1, l2)),
               max_abs_err=max_err(o1, o2), tolerance=0.0)
    names = kernel_names(lambda: flash_fwd(*views, **kw))
    checks.add("flash_fwd.bshd_views_launch_no_copy",
               len(names) == 1 and "flash_fwd_kernel" in names[0], kernels=names)
    return names


# K10/K11 (and K9) where the backward's tiling can break it (64-key blocks,
# 64-row q tiles from a TMA ring, the per-entry mask on boundary pairs only):
# untimed, both routes under the 3x rule
FLASH_BWD_TILING = [  # (name, b, h, h_k, sq, sk, d, options)
    ("sq1_causal_sk700", 1, 8, 2, 1, 700, 128, dict(causal=True)),
    ("sk_below_tile_40x33_causal", 2, 4, 2, 40, 33, 128, dict(causal=True)),
    ("sk_below_tile_100x20", 1, 4, 2, 100, 20, 128, dict()),
    ("ragged_300x1000_causal", 1, 8, 2, 300, 1000, 128, dict(causal=True)),
    ("ragged_1000x300", 1, 8, 2, 1000, 300, 128, dict()),
    ("kv_lens_in_tile", 2, 8, 2, 256, 256, 128, dict(causal=True, kv_lens=[100, 37])),
    ("window_edge_in_tile", 1, 8, 2, 512, 512, 128, dict(window=(100, 30))),
    ("window_left_causal_in_tile", 1, 8, 2, 384, 384, 128, dict(causal=True, window=(77, -1))),
    ("gqa_4_1_s512", 1, 32, 8, 512, 512, 128, dict(causal=True)),
    ("segments_ragged", 2, 8, 2, 200, 200, 128, dict(causal=True, segments=True)),
    ("softcap_ragged", 1, 8, 2, 130, 190, 128, dict(causal=True, softcap=30.0)),
    ("fp16_d64", 2, 8, 2, 300, 300, 64, dict(causal=True, dtype=torch.float16)),
    ("fp16_d128_kv_lens", 1, 8, 2, 200, 200, 128,
     dict(causal=True, kv_lens=[150], dtype=torch.float16)),
    ("bf16_d64_gqa", 1, 16, 4, 700, 700, 64, dict(causal=True)),
]
BWD_TILING_PACKED = (37, 100, 64, 130)  # prompt lengths of the positions case
BWD_TILING_DROPOUT = (1, 8, 2, 300, 300, 128)  # (b, h, h_k, sq, sk, d), ALiBi + dropout


def check_flash_bwd_tiling(gen, checks, cfg):
    """K9 + K10 and K11 on FLASH_BWD_TILING under the 3x rule, then with the
    options (check_flash_bwd_options)."""
    for name, *shape, opts in FLASH_BWD_TILING:
        check_flash_bwd(gen, checks, f"tiling.{name}", *shape, opts)
    check_flash_bwd_options(gen, checks, cfg)


def check_flash_bwd_options(gen, checks, cfg):
    """K9 + K10 and K11 in the options' instantiation under the 3x rule: with
    explicit positions, segment ids and per-row ALiBi over packed prompts,
    and with ALiBi and dropout (the oracle given the port's dropout mask)."""
    from xf_flash_attention_cutlass_tpu_torch.ops.flash_fwd import dropout_keep_mask
    from xf_flash_attention_cutlass_tpu_torch.utils.testing import alibi_slopes_ref

    tensors, kw = packed_case(gen, cfg, BWD_TILING_PACKED)
    check_flash_bwd_inputs(checks, "tiling.packed_positions_row_alibi", tensors, kw)
    b, h, h_k, sq, sk, d = BWD_TILING_DROPOUT
    (q, k, v, do), _ = flash_case(gen, b, h, h_k, sq, sk, d, {})
    slopes = torch.from_numpy(alibi_slopes_ref(h)).cuda()
    kw = dict(causal=True, alibi_slopes=slopes, dropout_p=API_P, dropout_seed=API_SEED)
    okw = dict(causal=True, alibi_slopes=slopes, dropout_p=API_P,
               dropout_mask=dropout_keep_mask(API_SEED, API_P, b, h, sq, sk, "cuda"))
    check_flash_bwd_inputs(checks, "tiling.alibi_dropout", (q, k, v, do), kw, okw)


def check_flash_bwd_views(gen, checks, cfg):
    """q, k, v and dO as the (b, s, h, d) views the model passes, at the
    training shape: FlashBwdLaunch reads them as they are (no copy) and
    writes dq, dk, dv in their memory layout; K9 and K10 give the same bits
    as on contiguous copies, and K11 the same dK, dV bits and its dQ within
    check_flash_bwd_repeat's bound."""
    from xf_flash_attention_cutlass_tpu_torch.ops.flash_bwd import FlashBwdLaunch
    from xf_flash_attention_cutlass_tpu_torch.ops.flash_fwd import flash_fwd_ref

    h, h_k, d, s = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, 1024
    views = [torch.randn((1, s, n, d), generator=gen, device="cuda").bfloat16().transpose(1, 2)
             for n in (h, h_k, h_k, h)]
    q, k, v, do = views
    kw = dict(causal=True)
    o, lse = flash_fwd_ref(q, k, v, **kw)
    run = FlashBwdLaunch(q, k, v, o, lse, do, **bwd_launch_kw(kw, d))
    got = (run.dq(), *run.dkv(), *run.fused())
    no_copy = all(a.data_ptr() == b.data_ptr() for a, b in zip((run.q, run.k, run.v, run.do),
                                                                 views))
    layout = (got[0].stride() == q.stride() and got[1].stride() == k.stride()
              and got[2].stride() == v.stride() and got[3].stride() == q.stride())
    checks.add("flash_bwd.bshd_views_no_copy", no_copy and layout, no_copy=no_copy,
               outputs_in_input_layout=layout)
    flat = [t.contiguous() for t in views]
    run_c = FlashBwdLaunch(*flat[:3], o, lse, flat[3], **bwd_launch_kw(kw, d))
    want = (run_c.dq(), *run_c.dkv(), *run_c.fused())
    torch.cuda.synchronize()
    exact = all(torch.equal(a, b) for i, (a, b) in enumerate(zip(got, want)) if i != 3)
    err, tol = max_err(got[3], want[3]), float(want[0].float().abs().max()) / 128
    checks.add("flash_bwd.bshd_views_same_result", exact and err <= tol,
               max_abs_err=max(max_err(a, b) for a, b in zip(got, want)), bit_equal_k9_k10=exact,
               fused_dq_err=err, fused_dq_tolerance=tol)


def check_attention_block_launches(gen, checks, cfg):
    """One attention_block of Llama-8B (one layer, 1024 tokens, random
    weights) under a profiler trace, against attn_qkv alone on the same
    inputs: the block's kernels must be attn_qkv's (norm, projections,
    rotary), then flash_fwd_kernel, with nothing between, so K7's wrapper
    neither copies nor scales q, k and v on the model path. Returns the
    block's kernel names."""
    from xf_flash_attention_cutlass_tpu_torch.models.llama import (
        attention_block,
        attn_qkv,
        init_params,
        layer_view,
    )
    from xf_flash_attention_cutlass_tpu_torch.ops.rotary import rotary_frequencies

    c1 = dataclasses.replace(cfg, n_layers=1)
    layer = layer_view(init_params(gen, c1)["layers"], 0)
    x = torch.randn((1, 1024, cfg.dim), generator=gen, device="cuda").bfloat16()
    cos, sin = rotary_frequencies(cfg.head_dim, cfg.max_seq_len, cfg.rope_base, device="cuda")
    pos = torch.arange(1024, device="cuda")[None]
    with torch.no_grad():
        attention_block(layer, x, cfg, cos, sin, pos)  # warm-up
        prep = kernel_names(lambda: attn_qkv(layer, x, cfg, cos, sin, pos))
        block = kernel_names(lambda: attention_block(layer, x, cfg, cos, sin, pos))
    n = len(prep)
    ok = block[:n] == prep and len(block) > n and "flash_fwd_kernel" in block[n]
    diff = next((i for i, (a, b) in enumerate(zip(prep, block)) if a != b), None)
    checks.add("flash_fwd.attention_block_nothing_before_k7", ok, qkv_kernels=n,
               next_kernel=block[n] if len(block) > n else None, first_difference=diff)
    return block


def kernel_names(fn):
    """The CUDA kernels one call of fn launches, in order (profiler trace).
    fn runs twice in the trace, a spin of the card between, and the kernels
    after the spin are returned: a trace has been seen to miss a kernel of
    the first call after the profiler starts."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda._sleep(1000)
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    names = [e.name[:120] for e in sorted(events, key=lambda e: e.time_range.start)]
    spins = [i for i, n in enumerate(names) if "spin_kernel" in n]
    if not spins:
        raise RuntimeError("kernel_names: the spin between the two calls is not in the trace")
    return names[spins[-1] + 1:]


def check_flash(gen, timer, checks, cfg):
    """K7 at the bucketed-prefill shapes (Llama-8B heads, one prompt whose
    kv_len is 70 % of its bucket; bucket 1024 timed, 256, 512 and 2048 not),
    at the training shape (s = 1024, causal, no kv_lens) and at s = 2048
    causal, both timed too, K9, K10 and K11 at the training shape, and the
    shapes off those paths, untimed. Returns the timed results by
    launch-counter name; K7's other timed shapes are under its
    `other_shapes`."""
    h, h_k, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    measured = {}
    for bucket in (256, 512, 1024, 2048):
        kv_len = int(0.7 * bucket)
        x, kw, err, tol = check_flash_fwd(gen, checks, f"bucket{bucket}_kv{kv_len}", 1, h, h_k,
                                          bucket, bucket, d, dict(causal=True, kv_lens=[kv_len]))
        if bucket == 1024:
            measured["flash_fwd"] = time_flash_fwd(timer, *x, kw, err, tol)
        del x
    other = measured["flash_fwd"]["other_shapes"] = {}
    for name, s in (("train_s1024", 1024), ("causal_s2048", 2048)):
        x, kw, err, tol = check_flash_fwd(gen, checks, name, 1, h, h_k, s, s, d,
                                          dict(causal=True))
        other[name] = time_flash_fwd(timer, *x, kw, err, tol)
        del x
    tensors, kw, worst = check_flash_bwd(gen, checks, "train_s1024", 1, h, h_k, 1024, 1024, d,
                                         dict(causal=True))
    measured.update(time_flash_bwd(timer, tensors, kw, worst))
    check_flash_bwd_repeat(checks, tensors, kw, "train_s1024")
    del tensors
    for name, *shape, opts in FLASH_OFF_PATH:
        check_flash_fwd(gen, checks, f"other.{name}", *shape, opts)
        check_flash_bwd(gen, checks, f"other.{name}", *shape, opts)
    return measured


# ---- phase 2: the API's options (K7, K9-K11 with ALiBi, positions, dropout; K8; K1) --

API_P, API_SEED = 0.1, 1234  # the api path's dropout rate and seed
API_S = 2048  # flash_attn_func's sequence length on the api path


def serving_prompt_lens(seed):
    """The 8 prompt lengths serve() draws (221-1306 tokens, 5119 in all at
    seed 0)."""
    return [int(n) for n in np.random.default_rng(seed).integers(200, 1501, 8)]


def fitting_tail(lens):
    """The first index i with sum(lens[i:]) <= API_S and i < len(lens): the
    longest run of prompts from the end that packs into API_S tokens."""
    return min(i for i in range(len(lens)) if sum(lens[i:]) <= API_S)


def dense_probs(q, k, slopes, upcast):
    """Causal softmax probabilities with ALiBi (h,) slopes, written apart from
    the kernels: f32 throughout, or with q times the scale, K and the scores
    rounded to q's dtype (the low-precision oracle)."""
    b, h, sq, d = q.shape
    dt = torch.float32 if upcast else q.dtype
    kx = k.to(dt).repeat_interleave(h // k.shape[1], dim=1)
    sc = ((q.to(dt) / math.sqrt(d)).to(dt) @ kx.transpose(-1, -2)).float()
    i = torch.arange(sq, device=q.device)[:, None]
    j = torch.arange(k.shape[2], device=q.device)[None]
    sc = sc - slopes[None, :, None, None] * (i - j).abs().float()
    return torch.softmax(sc.masked_fill(j > i, -torch.inf), dim=-1)


PROBS_RTOL, PROBS_ATOL = 1e-4, 1e-6  # K8 against its plain version, entry by entry


def check_probs(checks, name, q, k, lse, kw):
    """K8 on given inputs and options against its plain version, entry by
    entry: |K8 - plain| <= 1e-4 |plain| + 1e-6, signs included (an entry the
    dropout dropped is negative in both), the sign bits equal everywhere
    (0 mismatches), and the rows of |K8| that see a key summing to 1 within
    1e-3 (K8 writes P before the 1 / (1 - p) of dropout). Returns (K8's
    plane, its largest distance from the plain version, the sign
    mismatches)."""
    from xf_flash_attention_cutlass_tpu_torch.ops.flash_fwd import (
        attention_probs,
        attention_probs_ref,
    )

    probs = attention_probs(q, k, lse, **kw)
    plain = attention_probs_ref(q, k, lse, **kw)
    torch.cuda.synchronize()
    diff = (probs - plain).abs()
    err = float(diff.max())
    excess = float((diff - PROBS_RTOL * plain.abs()).max())
    del diff
    mismatches = int((torch.signbit(probs) != torch.signbit(plain)).sum())
    del plain
    live = torch.isfinite(lse)
    sums = probs.abs().sum(-1)[live]
    sums_err = max_err(sums, torch.ones_like(sums))
    checks.add(f"flash_probs[{name}]", bool(torch.isfinite(probs).all()) and excess <= PROBS_ATOL
               and mismatches == 0 and sums_err <= 1e-3, max_abs_err=err,
               excess_over_relative_tolerance=excess, tolerance=PROBS_ATOL,
               relative_tolerance=PROBS_RTOL, sign_mismatches=mismatches,
               row_sum_err=sums_err, row_sum_tolerance=1e-3,
               criterion="|K8 - plain| <= 1e-4 |plain| + 1e-6 on every entry")
    return probs, err, mismatches


# K8's shapes and options beyond the api path's: (name, b, h, h_k, sq, sk, d,
# dtype, options; "alibi" takes alibi_slopes_ref, "segments" two segment ids a
# row, "views" q and k as (b, s, h, d) tensors seen through transposes, read
# by their strides). sk % 4 != 0 stores the plane without TMA; sq and sk off
# the 64-row tiles, sk below one tile, one query row, a window from both
# sides, d = 64 with h_k < h, fp16, and segment ids with dead tiles between
# live ones.
PROBS_CASES = [
    ("sk301_gqa_dropout", 2, 8, 2, 200, 301, 128, torch.bfloat16,
     dict(causal=True, dropout_p=0.1, dropout_seed=7)),
    ("d64_gqa_alibi_dropout", 1, 8, 2, 256, 256, 64, torch.bfloat16,
     dict(causal=True, alibi=True, dropout_p=0.1, dropout_seed=8)),
    ("fp16_noncausal", 1, 4, 4, 192, 320, 128, torch.float16, dict()),
    ("fp16_d64_sk130_dropout", 2, 4, 1, 77, 130, 64, torch.float16,
     dict(dropout_p=0.2, dropout_seed=9)),
    ("window_softcap", 1, 4, 2, 300, 300, 64, torch.bfloat16,
     dict(window=(64, 16), softcap=30.0)),
    ("window_softcap_alibi_sk299", 1, 4, 2, 250, 299, 128, torch.bfloat16,
     dict(causal=True, window=(100, -1), softcap=20.0, alibi=True, dropout_p=0.1,
          dropout_seed=10)),
    ("sq1", 2, 8, 2, 1, 1000, 128, torch.bfloat16, dict(causal=True, alibi=True)),
    ("sk20", 1, 4, 2, 70, 20, 64, torch.float16, dict(causal=True)),
    ("segments_sk150", 2, 4, 2, 150, 150, 128, torch.bfloat16,
     dict(causal=True, segments=True, dropout_p=0.1, dropout_seed=11)),
    ("segments_sk256", 1, 8, 2, 256, 256, 64, torch.bfloat16,
     dict(causal=True, segments=True, alibi=True)),
    ("views_gqa_dropout", 2, 8, 2, 130, 200, 128, torch.bfloat16,
     dict(causal=True, views=True, dropout_p=0.1, dropout_seed=12)),
]


def probs_case(gen, b, h, h_k, sq, sk, d, dtype, opts):
    """q (b, h, sq, d), k (b, h_k, sk, d) and K8's keyword arguments for a
    PROBS_CASES row; segment ids split each row at 40 % of its tokens
    (self-attention: sq == sk)."""
    from xf_flash_attention_cutlass_tpu_torch.utils.testing import alibi_slopes_ref

    q = torch.randn((b, sq, h, d), generator=gen, device="cuda").to(dtype).transpose(1, 2)
    k = torch.randn((b, sk, h_k, d), generator=gen, device="cuda").to(dtype).transpose(1, 2)
    if not opts.get("views"):
        q, k = q.contiguous(), k.contiguous()
    kw = {n: x for n, x in opts.items() if n not in ("alibi", "segments", "views")}
    if opts.get("alibi"):
        kw["alibi_slopes"] = torch.from_numpy(alibi_slopes_ref(h)).cuda()
    if opts.get("segments"):
        seg = (torch.arange(sq, device="cuda") >= (2 * sq) // 5).int().expand(b, sq)
        kw.update(q_segment_ids=seg.contiguous(), kv_segment_ids=seg.contiguous())
    return q, k, kw


def check_probs_cases(gen, checks):
    """K8 at PROBS_CASES against its plain version (check_probs), each with
    the LSE of K7 under the same options."""
    from xf_flash_attention_cutlass_tpu_torch.ops.flash_fwd import flash_fwd

    for name, *shape in PROBS_CASES:
        q, k, kw = probs_case(gen, *shape)
        _, lse = flash_fwd(q, k, k, **kw)
        check_probs(checks, name, q, k, lse, kw)


PROBS_KERNEL = "flash_probs_kernel"  # K8's name in a profiler trace


def probs_shares(gen, timer, cfg, lens):
    """K8 at the api path's dense shape (b = 1, 2048 tokens, Llama-8B's 32 /
    8 heads, d = 128, bf16) in five variants, each on the Timer and on
    device (`device_ms`): as the api path calls it (causal, ALiBi, dropout
    0.1), at dropout 0, without ALiBi, non-causal, and with segment ids that
    never meet (every tile dead: the zero stores alone). The differences
    from the first are the shares of dropout's Philox, of ALiBi, and of the
    dead half of a causal plane. Then the api path's packed plane: the
    prompts of `lens` at the end of the list that fit in 2048 tokens, with
    positions, segment ids and per-row ALiBi (1921 tokens at seed 0, so
    sk % 4 != 0: no TMA stores)."""
    from xf_flash_attention_cutlass_tpu_torch.ops.flash_fwd import attention_probs, flash_fwd
    from xf_flash_attention_cutlass_tpu_torch.utils.testing import alibi_slopes_ref

    h, h_k, d, s = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, API_S
    q = torch.randn((1, h, s, d), generator=gen, device="cuda").bfloat16()
    k = torch.randn((1, h_k, s, d), generator=gen, device="cuda").bfloat16()
    api = dict(causal=True, alibi_slopes=torch.from_numpy(alibi_slopes_ref(h)).cuda(),
               dropout_p=API_P, dropout_seed=API_SEED)
    never = torch.zeros((1, s), dtype=torch.int32, device="cuda")
    variants = dict(api=api, p0=dict(api, dropout_p=0.0),
                    no_alibi={n: x for n, x in api.items() if n != "alibi_slopes"},
                    noncausal=dict(api, causal=False),
                    all_dead=dict(api, q_segment_ids=never, kv_segment_ids=never + 1))
    out = {}
    for name, kw in variants.items():
        _, lse = flash_fwd(q, k, k, **kw)
        out[name] = dict(ms=timer.ms(lambda: attention_probs(q, k, lse, **kw)),
                         device_ms=device_ms(lambda: attention_probs(q, k, lse, **kw),
                                             PROBS_KERNEL))
        del lse
    tail = lens[fitting_tail(lens):]
    (q, k, v, _), kw = packed_case(gen, cfg, tail)
    _, lse = flash_fwd(q, k, v, **kw)
    out[f"packed_T{sum(tail)}"] = dict(
        ms=timer.ms(lambda: attention_probs(q, k, lse, **kw)),
        device_ms=device_ms(lambda: attention_probs(q, k, lse, **kw), PROBS_KERNEL))
    return out


def check_api_dense(gen, timer, checks, cfg):
    """K7, K8 and K9/K10/K11 at flash_attn_func's api-path shape (b = 1,
    2048 tokens, causal, ALiBi slopes of alibi_slopes_ref, dropout 0.1): K7
    under the 2x rule against its plain version and the oracle given K8's
    mask; K8 entry by entry against its plain version (check_probs), and
    |K8| under the 2x rule against f32 and low-precision probabilities; the
    realized drop fraction within 0.01 of p; K9+K10 and K11 under the 3x
    rule. Returns K8's timed result, with K7's and K9/K10/K11's times at
    this shape and these options."""
    from xf_flash_attention_cutlass_tpu_torch.ops.flash_bwd import FlashBwdLaunch
    from xf_flash_attention_cutlass_tpu_torch.ops.flash_fwd import (
        attention_mask,
        attention_probs,
        attention_probs_ref,
        flash_fwd,
    )
    from xf_flash_attention_cutlass_tpu_torch.utils.testing import alibi_slopes_ref

    h, h_k, d, s = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, API_S
    q, k, v, do = (torch.randn(sh, generator=gen, device="cuda").bfloat16()
                   for sh in ((1, h, s, d), (1, h_k, s, d), (1, h_k, s, d), (1, h, s, d)))
    slopes = torch.from_numpy(alibi_slopes_ref(h)).cuda()
    kw = dict(causal=True, alibi_slopes=slopes, dropout_p=API_P, dropout_seed=API_SEED)
    o, lse = flash_fwd(q, k, v, **kw)
    probs, pplain, mismatches = check_probs(checks, "api_s2048_alibi_dropout", q, k, lse, kw)
    visible = attention_mask(1, s, s, "cuda", causal=True).expand(1, h, s, s)
    dropped = torch.signbit(probs) & visible
    fraction = float(dropped.sum()) / float(visible.sum())
    checks.add("dropout.realized_fraction[api_s2048]", abs(fraction - API_P) < 0.01,
               max_abs_err=abs(fraction - API_P), tolerance=0.01, fraction=fraction, p=API_P)
    p32, plp = dense_probs(q, k, slopes, True), dense_probs(q, k, slopes, False)
    ptol = 2 * max_err(plp, p32) + 1e-5
    perr = max_err(probs.abs(), p32)
    del plp, p32
    checks.add("flash_probs.vs_f32_oracle[api_s2048_alibi_dropout]",
               perr <= ptol, max_abs_err=perr, tolerance=ptol)
    okw = dict(causal=True, alibi_slopes=slopes, dropout_mask=~dropped, dropout_p=API_P)
    check_flash_fwd_inputs(checks, "api_s2048_alibi_dropout", q, k, v, kw, okw)
    check_flash_bwd_inputs(checks, "api_s2048_alibi_dropout", (q, k, v, do), kw, okw)
    pairs = h * int(visible[0, 0].sum())
    out = dict(ms=timer.ms(lambda: attention_probs(q, k, lse, **kw)),
               plain_ms=timer.ms(lambda: attention_probs_ref(q, k, lse, **kw), PLAIN_REPS),
               library_ms=None, bound=bound(nbytes(q, k, lse, probs), 2 * d * pairs),
               # |plain| <= 1: the entrywise tolerance is at most this
               err=pplain, tol=PROBS_RTOL + PROBS_ATOL, sign_mismatches=mismatches,
               drop_fraction=fraction,
               flash_fwd_ms=timer.ms(lambda: flash_fwd(q, k, v, **kw)))
    run = FlashBwdLaunch(q, k, v, o, lse, do, scale=1.0 / math.sqrt(d), causal=True,
                         window=(-1, -1), softcap=0.0, kv_lens=None, q_segment_ids=None,
                         kv_segment_ids=None, alibi_slopes=slopes, dropout_p=API_P,
                         dropout_seed=API_SEED)
    out.update(flash_bwd_dq_ms=timer.ms(run.dq), flash_bwd_dkv_ms=timer.ms(run.dkv),
               flash_bwd_fused_ms=timer.ms(run.fused))
    return out


def packed_case(gen, cfg, lens):
    """Packed q (1, h, T, d), k, v, dO (1, h_k, T, d) bf16 of the sequences
    of `lens` (self-attention, T = sum), and the kernel options the varlen
    entry builds from per-sequence (len(lens), h) ALiBi slopes."""
    from xf_flash_attention_cutlass_tpu_torch.ops.varlen import (
        _packed_positions,
        _row_slopes_from_segments,
    )

    h, h_k, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    T = sum(lens)
    cu = torch.tensor(np.cumsum([0] + list(lens)), dtype=torch.int32, device="cuda")
    q, k, v, do = (torch.randn(sh, generator=gen, device="cuda").bfloat16()
                   for sh in ((1, h, T, d), (1, h_k, T, d), (1, h_k, T, d), (1, h, T, d)))
    slopes = torch.rand((len(lens), h), generator=gen, device="cuda") * 0.1
    qseg, kseg, qpos, kpos = _packed_positions(cu, cu, T, T)
    kw = dict(causal=True, q_segment_ids=qseg[None], kv_segment_ids=kseg[None],
              q_positions=qpos[None], kv_positions=kpos[None],
              alibi_row_slopes=_row_slopes_from_segments(slopes, qseg))
    return (q, k, v, do), kw


def check_api_packed(gen, timer, checks, cfg, lens):
    """The packed varlen route's kernels at the api path's shapes, with
    per-row ALiBi slopes, explicit positions and segment ids: K7 over the
    packed serving prompts under the 2x rule, timed with and without the
    tile tables that skip the tile pairs of different prompts (the results
    must be equal); K9+K10 and K11 over the same tokens under the 3x rule;
    K8 over the prompts at the end of the list that fit in 2048 tokens,
    entry by entry against its plain version (check_probs)."""
    from xf_flash_attention_cutlass_tpu_torch.ops.flash_fwd import (
        Extras,
        _flash_fwd_cuda,
        flash_fwd,
    )

    (q, k, v, do), kw = packed_case(gen, cfg, lens)
    b, h, T, d = q.shape
    err, tol = check_flash_fwd_inputs(checks, f"api_packed_T{T}", q, k, v, kw)
    ex = Extras(b, h, T, T, q.device, **{n: x for n, x in kw.items() if n != "causal"})
    ex.struct.qtiles = ex.struct.ktiles = None  # walk every key tile below kv_len

    def walk_all():
        return _flash_fwd_cuda(q, k, v, 1.0 / math.sqrt(d), True, (-1, -1), 0.0, None,
                               kw["q_segment_ids"], kw["kv_segment_ids"], ex)

    same = max_err(walk_all()[0], flash_fwd(q, k, v, **kw)[0])
    checks.add(f"flash_fwd.api_packed_T{T}.tile_skip_same_result", same == 0.0,
               max_abs_err=same, tolerance=0.0)
    out = dict(T=T, ms=timer.ms(lambda: flash_fwd(q, k, v, **kw)),
               ms_without_tile_skip=timer.ms(walk_all), err=err, tol=tol)
    check_flash_bwd_inputs(checks, f"api_packed_T{T}", (q, k, v, do), kw)
    del q, k, v, do
    tail = lens[fitting_tail(lens):]
    (q, k, v, _), kw = packed_case(gen, cfg, tail)
    _, lse = flash_fwd(q, k, v, **kw)
    check_probs(checks, f"api_packed_T{sum(tail)}", q, k, lse, kw)
    return out


def options_decode_inputs(gen, cfg):
    """The second kvcache call of the api path: b = 8 decode over a dense
    (8, 4096, 8, 128) bf16 cache viewed as page-256 pages, kv_lens from
    1024-4096, and its options: window (1024, 0), softcap 30, ALiBi and
    leftpads from 0-299. Returns (q, k_pool, v_pool, bt, lens, options)."""
    from xf_flash_attention_cutlass_tpu_torch.ops.kvcache import dense_cache_as_paged
    from xf_flash_attention_cutlass_tpu_torch.utils.testing import alibi_slopes_ref

    h, h_k, d, b, sk = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, 8, 4096
    kd, vd = (torch.randn((b, sk, h_k, d), generator=gen, device="cuda").bfloat16()
              for _ in range(2))
    kp, pages = dense_cache_as_paged(kd, 256)
    vp, _ = dense_cache_as_paged(vd, 256)
    del kd, vd
    bt = (torch.arange(b, dtype=torch.int32, device="cuda")[:, None] * pages
          + torch.arange(pages, dtype=torch.int32, device="cuda")[None])
    lens = torch.randint(1024, sk + 1, (b,), generator=gen, device="cuda").int()
    q = torch.randn((b, 1, h, d), generator=gen, device="cuda").bfloat16()
    full = dict(window=(1024, 0), softcap=30.0,
                alibi_slopes=torch.from_numpy(alibi_slopes_ref(h)).cuda(),
                cache_leftpad=torch.randint(0, 300, (b,), generator=gen, device="cuda").int())
    return q, kp, vp, bt, lens, full


def options_chunk_inputs(gen, kv_dtype, cfg):
    """A 256-token chunk at b = 2 over page-256 pools (two layers of 64
    pages, 16-page tables; layer 1 read) at kv_len 1024 and 700, and the
    options: window (300, 0), softcap 30, (b, h) ALiBi slopes and leftpads
    100 and 530 (the second entry's first 86 rows see no key). Returns
    (q, k_pool, v_pool, k_scales, v_scales, bt, lens, options)."""
    from xf_flash_attention_cutlass_tpu_torch.utils.testing import alibi_slopes_ref

    h, h_k, d, b, n_pages = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, 2, 64
    kp, vp, ks, vs = kv_pools(gen, kv_dtype, 2, n_pages, h_k, 256, d)
    bt = torch.stack([torch.randperm(n_pages, generator=gen, device="cuda")[:16]
                      for _ in range(b)]).int()
    lens = torch.tensor([1024, 700], dtype=torch.int32, device="cuda")
    q = torch.randn((b, 256, h, d), generator=gen, device="cuda").bfloat16()
    slopes = torch.from_numpy(alibi_slopes_ref(h)).cuda()
    full = dict(window=(300, 0), softcap=30.0,
                alibi_slopes=torch.stack([slopes, 0.5 * slopes]),
                cache_leftpad=torch.tensor([100, 530], dtype=torch.int32, device="cuda"))
    return q, kp, vp, ks, vs, bt, lens, full


def check_paged_options(checks, name, want, q, kp, vp, ks, vs, bt, lens, layer_idx=None,
                        **opts):
    """One K1 call with options under the 2x rule against its plain version
    and paged_attention_oracle: it must take route `want` and launch that
    route's options instantiation once; rows that see no key give O = 0
    and LSE = -inf where the oracle's LSE is -inf. Returns (plain_err, tol,
    splits)."""
    from xf_flash_attention_cutlass_tpu_torch import _build
    from xf_flash_attention_cutlass_tpu_torch.ops.paged import (
        paged_attention,
        paged_attention_ref,
        paged_plan,
        route_label,
    )
    from xf_flash_attention_cutlass_tpu_torch.utils.testing import paged_attention_oracle

    sq, h = q.shape[1], q.shape[2]
    route, splits = paged_plan(q.shape, kp.shape, kp.dtype, bt.shape[1], **opts)
    label = route_label(route, sq * (h // kp.shape[-3]), True)
    sc = {} if ks is None else dict(k_scales=ks, v_scales=vs)
    pick = (lambda x: x) if layer_idx is None else (lambda x: None if x is None else x[layer_idx])
    sc1 = {} if ks is None else dict(k_scales=pick(ks), v_scales=pick(vs))
    n0 = _build.LAUNCHES[label]
    o, lse = paged_attention(q, kp, vp, bt, lens, layer_idx=layer_idx, **sc, **opts)
    launched = _build.LAUNCHES[label] - n0 == 1
    o_plain, _ = paged_attention_ref(q, pick(kp), pick(vp), bt, lens, num_splits=splits, **sc1,
                                     **opts)
    o32, l32 = paged_attention_oracle(q, pick(kp), pick(vp), bt, lens, **sc1, **opts)
    olp, _ = paged_attention_oracle(q, pick(kp), pick(vp), bt, lens, upcast=False, **sc1, **opts)
    torch.cuda.synchronize()
    tol = 2 * max_err(olp, o32) + 1e-5
    err, plain_err = max_err(o, o32), max_err(o, o_plain)
    dead = torch.isneginf(l32)
    dead_ok = torch.equal(torch.isneginf(lse), dead) and bool(
        (o.transpose(1, 2)[dead] == 0).all())
    checks.add(name, bool(torch.isfinite(o).all()) and err <= tol and plain_err <= tol
               and dead_ok and launched and route == want,
               max_abs_err=plain_err, tolerance=tol, err_vs_f32_oracle=err, num_splits=splits,
               route=route, expected_route=want, launched=launched, dead_rows=int(dead.sum()),
               dead_rows_ok=dead_ok)
    return plain_err, tol, splits


def check_paged_extras(gen, timer, checks, cfg):
    """K1's options instantiations. Decode (options_decode_inputs: the api
    path's second kvcache call) with each of window, softcap, ALiBi and
    leftpad, and all four: each call must take, and launch, the decode
    route's options instantiation (`paged_attention.decode.options`).
    Chunk (options_chunk_inputs) at fp8, int8 and bf16 with each option, all
    four, and a non-causal right window of 37 keys: each must launch the
    chunk route's (`paged_attention.prefill.options`). Each under the 2x
    rule (check_paged_options). Timed: the all-four decode call (its plain
    version, bound, the option-free call on the same cache, `ms_no_options`)
    and the all-four fp8 chunk call (the option-free and the ALiBi-of-slope-0
    calls on the same inputs beside it); and the WMMA kernel's options
    instantiation forced onto both, held to the same rule against the plain
    version and timed. Returns the rows of `paged_attention.decode.options`,
    `paged_attention.prefill.options` and `paged_attention.decode.wmma`."""
    from xf_flash_attention_cutlass_tpu_torch.ops.paged import paged_attention, paged_attention_ref

    q, kp, vp, bt, lens, full = options_decode_inputs(gen, cfg)
    for name, opts in [(n, {n: x}) for n, x in full.items()] + [("all", full)]:
        err, tol, splits = check_paged_options(checks, f"paged_attention.decode.options[{name}]",
                                               "decode", q, kp, vp, None, None, bt, lens, **opts)
    out = {}
    plain_ms = timer.ms(lambda: paged_attention_ref(q, kp, vp, bt, lens, num_splits=splits,
                                                    **full), PLAIN_REPS)
    dec_bound = k1_bound(q, kp, None, bt, lens, **full)
    out["paged_attention.decode.options"] = dict(
        ms=timer.ms(lambda: paged_attention(q, kp, vp, bt, lens, **full)), err=err, tol=tol,
        plain_ms=plain_ms, bound=dec_bound, library_ms=None, splits=splits,
        ms_no_options=timer.ms(lambda: paged_attention(q, kp, vp, bt, lens)))
    wmma_splits, wmma = forced_route("wmma", q, kp, vp, None, None, bt, lens, None, **full)
    o_plain, _ = paged_attention_ref(q, kp, vp, bt, lens, num_splits=wmma_splits, **full)
    o, _ = wmma()
    werr = max_err(o, o_plain)
    checks.add("paged_attention.decode.wmma[options,forced]", werr <= tol, max_abs_err=werr,
               tolerance=tol, num_splits=wmma_splits)
    out["paged_attention.decode.wmma"] = dict(
        ms=timer.ms(wmma), err=werr, tol=tol, plain_ms=plain_ms, bound=dec_bound, library_ms=None,
        splits=wmma_splits)
    del kp, vp

    for kv_dtype in (torch.float8_e4m3fn, torch.int8, torch.bfloat16):
        q, kp, vp, ks, vs, bt, lens, full = options_chunk_inputs(gen, kv_dtype, cfg)
        cases = [(n, {n: x}) for n, x in full.items()] + [
            ("all", full), ("right_window", dict(causal=False, window=(-1, 37)))]
        for name, opts in cases:
            err, tol, splits = check_paged_options(
                checks, f"paged_attention.prefill.options[{str(kv_dtype).split('.')[-1]},{name}]",
                "wgmma", q, kp, vp, ks, vs, bt, lens, 1, **opts)
            if kv_dtype == torch.float8_e4m3fn and name == "all":
                r = dict(err=err, tol=tol, splits=splits)
        if kv_dtype != torch.float8_e4m3fn:
            continue
        sc = dict(k_scales=ks, v_scales=vs)
        sc1 = dict(k_scales=ks[1], v_scales=vs[1])
        zero = torch.zeros(cfg.n_heads, device="cuda")
        wmma_splits, wmma = forced_route("wmma", q, kp, vp, ks, vs, bt, lens, **full)
        r.update(
            ms=timer.ms(lambda: paged_attention(q, kp, vp, bt, lens, layer_idx=1, **sc, **full)),
            plain_ms=timer.ms(lambda: paged_attention_ref(
                q, kp[1], vp[1], bt, lens, num_splits=r["splits"], **sc1, **full), PLAIN_REPS),
            bound=k1_bound(q, kp, ks, bt, lens, **full), library_ms=None,
            ms_no_options=timer.ms(lambda: paged_attention(q, kp, vp, bt, lens, layer_idx=1,
                                                           **sc)),
            ms_alibi0=timer.ms(lambda: paged_attention(q, kp, vp, bt, lens, layer_idx=1,
                                                       alibi_slopes=zero, **sc)),
            wmma_ms=timer.ms(wmma), wmma_splits=wmma_splits)
        o_plain, _ = paged_attention_ref(q, kp[1], vp[1], bt, lens, num_splits=wmma_splits,
                                         **sc1, **full)
        o, _ = wmma()
        werr = max_err(o, o_plain)
        checks.add("paged_attention.prefill.wmma[options,forced]", werr <= r["tol"],
                   max_abs_err=werr, tolerance=r["tol"], num_splits=wmma_splits)
        out["paged_attention.prefill.options"] = r
        del kp, vp, ks, vs
    return out


def api_path(gen, cfg, seed):
    """The public API at Llama-8B attention width (32 / 8 heads, d = 128,
    bf16, inputs from the seeded generator), through the wrappers a user
    calls:
    (a) flash_attn_func, b = 1, 2048 tokens, causal, ALiBi, dropout 0.1,
        return_attn_probs, and the gradient of sum(out * w);
    (b) packed flash_attn_varlen_func over the 8 serving prompts, causal,
        (8, 32) ALiBi slopes, its gradient, and return_attn_probs over the
        prompts at the end of the list that fit in 2048 tokens;
    (c) paged flash_attn_varlen_func over a bf16 page-256 cache holding the
        8 prompts' keys, for the last 256 tokens of each (all of a shorter
        one), causal; then again with window (512, 0), softcap 30 and (b)'s
        (8, 32) ALiBi slopes;
    (d) flash_attn_with_kvcache: one decode token per prompt with a NeoX
        rotary append (dim 128, base 500000) on that cache; then a decode on
        a dense (8, 4096, 8, 128) cache with softcap 30, window (1024, 0),
        ALiBi and cache_leftpad.
    Returns the outputs the checks after the path read, the seconds of each
    step's first (cold) call on the host clock, each step's call, and the
    copies of the caller's caches into K1's page layout that the K1 steps
    make, so that time_api_steps can time them again warm. Calling a step
    again repeats its work: (d) appends the same token at the same place."""
    import xf_flash_attention_cutlass_tpu_torch as xfa
    from xf_flash_attention_cutlass_tpu_torch.ops.kvcache import (
        DEFAULT_PAGE,
        dense_cache_as_paged,
    )
    from xf_flash_attention_cutlass_tpu_torch.ops.rotary import rotary_frequencies
    from xf_flash_attention_cutlass_tpu_torch.utils.testing import alibi_slopes_ref

    h, h_k, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    secs, res, calls = {}, {}, {}

    def randn(*sh):
        return torch.randn(sh, generator=gen, device="cuda").bfloat16()

    def first_call(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs[name], calls[name] = time.perf_counter() - t0, fn
        return out

    xa = [randn(1, API_S, h, d).requires_grad_(True), randn(1, API_S, h_k, d).requires_grad_(True),
          randn(1, API_S, h_k, d).requires_grad_(True)]
    wa = randn(1, API_S, h, d)
    slopes = torch.from_numpy(alibi_slopes_ref(h)).cuda()

    def dense():
        out, _, s_dmask = xfa.flash_attn_func(*xa, dropout_p=API_P, causal=True,
                                              alibi_slopes=slopes, return_attn_probs=True,
                                              dropout_seed=API_SEED)
        grads = torch.autograd.grad((out.float() * wa.float()).sum(), xa)
        return dict(out=out.detach(), s_dmask=s_dmask, grads=grads)

    res["dense"] = first_call("dense", dense)

    lens = serving_prompt_lens(seed)
    T, nb = sum(lens), len(lens)
    cu = torch.tensor(np.cumsum([0] + lens), dtype=torch.int32, device="cuda")
    xb = [randn(T, h, d).requires_grad_(True), randn(T, h_k, d).requires_grad_(True),
          randn(T, h_k, d).requires_grad_(True)]
    wb = randn(T, h, d)
    slopes_b = torch.rand((nb, h), generator=gen, device="cuda") * 0.1
    vkw = dict(max_seqlen_q=max(lens), max_seqlen_k=max(lens), causal=True)
    q, k, v = (t.detach() for t in xb)
    i_n = fitting_tail(lens)
    t0_n, cu_n = int(cu[i_n]), cu[i_n:] - cu[i_n]

    def packed():
        out = xfa.flash_attn_varlen_func(*xb, cu, cu, alibi_slopes=slopes_b, **vkw)
        grads = torch.autograd.grad((out.float() * wb.float()).sum(), xb)
        out_n, _, probs_n = xfa.flash_attn_varlen_func(
            q[t0_n:], k[t0_n:], v[t0_n:], cu_n, cu_n, alibi_slopes=slopes_b[i_n:],
            return_attn_probs=True, **vkw)
        return dict(out=out.detach(), grads=grads, out_n=out_n, probs_n=probs_n, start=t0_n,
                    cu_n=cu_n)

    res["packed"] = first_call("packed", packed)

    page, q_len = 256, 256
    pages_of = [-(-(n_ + 1) // page) for n_ in lens]  # room for (d)'s appended token
    perm = torch.randperm(sum(pages_of) + 1, generator=gen, device="cuda").int()
    bt = torch.full((nb, max(pages_of)), int(perm[-1]), dtype=torch.int32, device="cuda")
    k_cache = torch.zeros((len(perm), page, h_k, d), dtype=torch.bfloat16, device="cuda")
    v_cache = torch.zeros_like(k_cache)
    q_rows, used = [], 0
    for i, n_ in enumerate(lens):
        bt[i, :pages_of[i]] = perm[used:used + pages_of[i]]
        used += pages_of[i]
        pos = torch.arange(n_, device="cuda")
        rows = int(cu[i]) + pos
        k_cache[bt[i, pos // page].long(), pos % page] = k[rows]
        v_cache[bt[i, pos // page].long(), pos % page] = v[rows]
        q_rows.append(rows[-min(q_len, n_):])
    q_c = q[torch.cat(q_rows)]
    q_lens = [min(q_len, n_) for n_ in lens]
    cu_q = torch.tensor(np.cumsum([0] + q_lens), dtype=torch.int32, device="cuda")

    def paged_varlen():
        return xfa.flash_attn_varlen_func(q_c, k_cache, v_cache, cu_q, cu, max_seqlen_q=q_len,
                                          max_seqlen_k=max(lens), causal=True, block_table=bt)

    res["paged"] = dict(out=first_call("paged_varlen", paged_varlen), q=q_c, q_lens=q_lens,
                        bt=bt)
    okw = dict(window_size=(512, 0), softcap=30.0, alibi_slopes=slopes_b)

    def paged_varlen_options():
        return xfa.flash_attn_varlen_func(q_c, k_cache, v_cache, cu_q, cu, max_seqlen_q=q_len,
                                          max_seqlen_k=max(lens), causal=True, block_table=bt,
                                          **okw)

    res["paged_options"] = dict(out=first_call("paged_varlen_options", paged_varlen_options),
                                kw=okw)

    lens_t = torch.tensor(lens, dtype=torch.int32, device="cuda")
    cos, sin = rotary_frequencies(d, 4096, base=500000.0, device="cuda")
    qd, kn, vn = randn(nb, 1, h, d), randn(nb, 1, h_k, d), randn(nb, 1, h_k, d)

    def kvcache_paged():
        return xfa.flash_attn_with_kvcache(
            qd, k_cache, v_cache, k=kn, v=vn, rotary_cos=cos, rotary_sin=sin,
            cache_seqlens=lens_t, block_table=bt, causal=True, rotary_interleaved=False)

    out_d1, kc, vc = first_call("kvcache_paged_append", kvcache_paged)
    res["kvcache_paged"] = dict(out=out_d1, q=qd, k_new=kn, v_new=vn, cos=cos, sin=sin,
                                lens=lens_t, k_cache=kc, v_cache=vc, bt=bt,
                                in_place=kc is k_cache and vc is v_cache)

    kd, vd = randn(nb, 4096, h_k, d), randn(nb, 4096, h_k, d)
    seqlens = torch.randint(1024, 4097, (nb,), generator=gen, device="cuda").int()
    leftpad = torch.randint(0, 300, (nb,), generator=gen, device="cuda").int()
    dkw = dict(causal=True, window_size=(1024, 0), softcap=30.0, alibi_slopes=slopes,
               cache_leftpad=leftpad)

    def kvcache_dense():
        return xfa.flash_attn_with_kvcache(qd, kd, vd, cache_seqlens=seqlens, **dkw)[0]

    res["kvcache_dense"] = dict(out=first_call("kvcache_dense_options", kvcache_dense), q=qd,
                                k=kd, v=vd, lens=seqlens, kw=dkw)
    res["lens"] = lens
    copies = {  # what (c) and (d) copy on every call before K1 reads the keys
        "paged_varlen": lambda: (k_cache.transpose(1, 2).contiguous(),
                                 v_cache.transpose(1, 2).contiguous()),
        "paged_varlen_options": lambda: (k_cache.transpose(1, 2).contiguous(),
                                         v_cache.transpose(1, 2).contiguous()),
        "kvcache_paged_append": lambda: (k_cache.transpose(1, 2).contiguous(),
                                         v_cache.transpose(1, 2).contiguous()),
        "kvcache_dense_options": lambda: (dense_cache_as_paged(kd, DEFAULT_PAGE),
                                          dense_cache_as_paged(vd, DEFAULT_PAGE)),
    }
    return res, secs, calls, copies


def time_api_steps(calls, copies, reps=5):
    """Each api step called again, warm: its host-clock ms over `reps`
    synchronized calls (least, median, largest) and its device ms per call
    from a profiler trace (`profiled`, API_TRACED_CALLS calls), with the device's
    busy share of the median call and K8's and K1's device ms per call; for
    the K1 steps, the device ms of the copy of the caller's caches into K1's
    page layout that the step makes, and its share of the step's device
    time."""
    out = {}
    for name, fn in calls.items():
        ms = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
        prof = profiled(fn, API_TRACED_CALLS, groups=dict(k8="flash_probs_kernel", k1="paged_"))
        dev = prof["device_ms_per_step"] if prof else None
        p50 = percentile(ms, 50)
        out[name] = dict(host_ms=dict(min=min(ms), p50=p50, max=max(ms)), device_ms=dev,
                         busy_share=dev / p50 if dev else None,
                         k8_device_ms=prof["groups_ms_per_step"]["k8"] if prof else None,
                         k1_device_ms=prof["groups_ms_per_step"]["k1"] if prof else None,
                         top=prof["top"][:4] if prof else None)
        if name in copies:
            cprof = profiled(copies[name], API_TRACED_CALLS)
            copy_ms = cprof["device_ms_per_step"] if cprof else None
            out[name].update(layout_copy_device_ms=copy_ms,
                             layout_copy_share=copy_ms / dev if copy_ms and dev else None)
    return out


def check_api_outputs(checks, res, cfg):
    """What the api path returned: finite values of the expected shapes; the
    realized drop fraction of (a)'s plane within 0.01 of p; (b)'s subset
    agreeing with the whole packed run within one bf16 rounding of the
    largest magnitude (the subset starts at another tile offset), its
    plane's rows summing to 1 within 1e-3 and its entries between two
    prompts 0; (c) and (d) under the 2x rule against K1's plain version and
    paged_attention_oracle on the same inputs; (d)'s append rotated and
    written in place into the caller's cache, bit for bit."""
    from xf_flash_attention_cutlass_tpu_torch.ops.kvcache import dense_cache_as_paged
    from xf_flash_attention_cutlass_tpu_torch.ops.paged import paged_attention_ref, paged_plan
    from xf_flash_attention_cutlass_tpu_torch.ops.rotary import apply_rotary
    from xf_flash_attention_cutlass_tpu_torch.utils.testing import paged_attention_oracle

    def finite(*ts):
        return all(bool(torch.isfinite(t).all()) for t in ts)

    def oracle_check(name, out, q, k_pool, v_pool, bt, lens, pick=None, **kw):
        """K1's output under the 2x rule against both its plain version (with
        the kernel's splits) and paged_attention_oracle, on the same inputs."""
        _, splits = paged_plan(q.shape, k_pool.shape, k_pool.dtype, bt.shape[1], **kw)
        o_plain, _ = paged_attention_ref(q, k_pool, v_pool, bt, lens, num_splits=splits, **kw)
        o32, _ = paged_attention_oracle(q, k_pool, v_pool, bt, lens, **kw)
        olp, _ = paged_attention_oracle(q, k_pool, v_pool, bt, lens, upcast=False, **kw)
        if pick is not None:
            o_plain, o32, olp = pick(o_plain), pick(o32), pick(olp)
        tol, err = 2 * max_err(olp, o32) + 1e-5, max_err(out, o32)
        plain_err = max_err(out, o_plain)
        checks.add(name, finite(out) and err <= tol and plain_err <= tol, max_abs_err=plain_err,
                   tolerance=tol, err_vs_f32_oracle=err, num_splits=splits)

    h = cfg.n_heads
    a = res["dense"]
    fraction = float(torch.signbit(a["s_dmask"]).sum()) / (API_S * (API_S + 1) // 2 * h)
    checks.add("api.flash_attn_func", finite(a["out"], *a["grads"])
               and tuple(a["s_dmask"].shape) == (1, h, API_S, API_S)
               and abs(fraction - API_P) < 0.01, drop_fraction=fraction, p=API_P)
    b = res["packed"]
    sub_err = max_err(b["out_n"], b["out"][b["start"]:])
    sub_tol = 2 ** -7 * float(b["out"][b["start"]:].abs().max())
    sums = b["probs_n"].sum(-1)
    sums_err = max_err(sums, torch.ones_like(sums))
    n_tok = b["probs_n"].shape[-1]
    seg = torch.searchsorted(b["cu_n"].long(), torch.arange(n_tok, device="cuda"), right=True)
    across = float(b["probs_n"][:, seg[:, None] != seg[None, :]].abs().max())
    checks.add("api.flash_attn_varlen_func.packed", finite(b["out"], *b["grads"], b["probs_n"])
               and sub_err <= sub_tol and sums_err <= 1e-3 and across == 0.0,
               subset_err=sub_err, subset_tolerance=sub_tol, row_sum_err=sums_err,
               row_sum_tolerance=1e-3, subset_prompts=len(b["cu_n"]) - 1,
               max_across_prompts=across)

    c, dd = res["paged"], res["kvcache_paged"]
    k_pool, v_pool = dd["k_cache"].transpose(1, 2), dd["v_cache"].transpose(1, 2)
    lens = torch.tensor(res["lens"], dtype=torch.int32, device="cuda")
    qr = c["q"].new_zeros((len(c["q_lens"]), 256, *c["q"].shape[1:]))  # right-aligned
    off = 0
    for i, n_ in enumerate(c["q_lens"]):
        qr[i, 256 - n_:] = c["q"][off:off + n_]
        off += n_

    def packed_rows(o):
        return torch.cat([o[i, 256 - n_:] for i, n_ in enumerate(c["q_lens"])])

    # (c) ran before (d)'s append, which no key of (c)'s queries sees
    oracle_check("api.flash_attn_varlen_func.paged", c["out"], qr, k_pool, v_pool, c["bt"],
                 lens, pick=packed_rows)
    okw = res["paged_options"]["kw"]
    oracle_check("api.flash_attn_varlen_func.paged_options", res["paged_options"]["out"], qr,
                 k_pool, v_pool, c["bt"], lens, pick=packed_rows, window=okw["window_size"],
                 softcap=okw["softcap"], alibi_slopes=okw["alibi_slopes"])
    pos = dd["lens"].long()
    k_rot = apply_rotary(dd["k_new"], dd["cos"], dd["sin"], pos[:, None], False)
    pe = dd["bt"].long().gather(1, (pos // 256)[:, None])[:, 0]
    appended = bool(torch.equal(dd["k_cache"][pe, pos % 256], k_rot[:, 0])
                    and torch.equal(dd["v_cache"][pe, pos % 256], dd["v_new"][:, 0]))
    checks.add("api.flash_attn_with_kvcache.append_in_place", appended and dd["in_place"],
               append_bit_equal=appended, in_place=dd["in_place"])
    q_rot = apply_rotary(dd["q"], dd["cos"], dd["sin"], pos[:, None], False)
    oracle_check("api.flash_attn_with_kvcache.paged_rotary", dd["out"], q_rot, k_pool, v_pool,
                 dd["bt"], dd["lens"] + 1)
    e = res["kvcache_dense"]
    kp, pages = dense_cache_as_paged(e["k"], 256)
    vp, _ = dense_cache_as_paged(e["v"], 256)
    bt = (torch.arange(e["k"].shape[0], device="cuda")[:, None] * pages
          + torch.arange(pages, device="cuda")[None]).int()
    kw = e["kw"]
    oracle_check("api.flash_attn_with_kvcache.dense_options", e["out"], e["q"], kp, vp, bt,
                 e["lens"], window=kw["window_size"], softcap=kw["softcap"],
                 alibi_slopes=kw["alibi_slopes"], cache_leftpad=kw["cache_leftpad"])


# ---- phase 3: training ----------------------------------------------------------

def train(gen, cfg, seed, steps=3, lr=0.005):
    """Plain SGD on one batch (b = 1, 1024 tokens made from the seed) with
    bf16 parameters at the widths of cfg: `steps` steps through the two-pass
    backward (K9, K10), one through the one-pass backward (K11), and one
    more two-pass step under the profiler. Every loss must be finite and
    below the one before it. The rate is small because the embedding
    (entries of about 0.02) feeds an RMS norm that scales its gradient up
    some 50x: at 1.0 the first step overshot. Returns (ok, a dict of the
    losses, the step times on the host clock around a synchronized step,
    and the profiled step's kernels)."""
    from xf_flash_attention_cutlass_tpu_torch.models.llama import init_params, loss_fn

    t0 = time.perf_counter()
    params = init_params(gen, cfg)
    leaves = [params["embed"], params["final_norm"], params["lm_head"],
              *params["layers"].values()]
    for t in leaves:
        t.requires_grad_(True)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(seed + 3)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 1025))).cuda()
    losses, step_ms = [], []

    def sgd_step(fused=None):
        loss = loss_fn(params, tokens, cfg, fused=fused)
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            for t, g in zip(leaves, grads):
                t.sub_(g, alpha=lr)
        losses.append(loss.detach())

    for i in range(steps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sgd_step(fused=True if i == steps else None)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
    prof = profiled(sgd_step)
    losses = [float(x) for x in losses]
    peak = torch.cuda.max_memory_allocated() / 1e9
    del params, leaves
    torch.cuda.empty_cache()
    ok = all(math.isfinite(x) for x in losses) and all(
        b < a for a, b in zip(losses, losses[1:]))
    return ok, dict(layers=cfg.n_layers, tokens=1024, lr=lr, losses=losses,
                    step_ms=step_ms, two_pass_step_ms_p50=percentile(step_ms[1:steps], 50),
                    fused_step_ms=step_ms[steps], init_s=init_s, peak_memory_gb=peak,
                    profile=prof)


# ---- phase 4: serving ---------------------------------------------------------

def reference_check(params, cfg, checks, seed):
    """The prefill and decode cores at Llama-8B width, cut to 2 layers, on
    the card (kernels) against the same cores on the CPU (plain versions),
    for one 128-token chunk, one decode step and one bucketed prefill (the
    same 100-token prompt in its 128-token bucket). 2x rule on the logits:
    the card's error against the CPU run in f32 is at most twice the CPU bf16
    run's error, plus 1e-5."""
    from xf_flash_attention_cutlass_tpu_torch.models.llama import pack_params_for_decode
    from xf_flash_attention_cutlass_tpu_torch.serve.engine import (
        decode_core,
        prefill_chunk_core,
        prefill_core,
    )

    n_layers, page, n_pages, C, n_valid = 2, 256, 4, 128, 100
    sub = dict(params, layers={
        k: ((v[0][:n_layers], v[1][:n_layers]) if isinstance(v, tuple) else v[:n_layers])
        for k, v in params["layers"].items()})

    def to(tree, dev, dtype=None):
        if isinstance(tree, dict):
            return {k: to(v, dev, dtype) for k, v in tree.items()}
        if isinstance(tree, tuple):
            return tuple(to(v, dev, dtype) for v in tree)
        if tree is None:
            return None
        t = tree.to(dev)
        if dtype is not None and t.dtype == torch.bfloat16:
            t = t.to(dtype)
        return t

    rng = np.random.default_rng(seed + 1)
    prompt = rng.integers(0, cfg.vocab_size, n_valid)
    next_token = int(rng.integers(0, cfg.vocab_size))
    runs, seconds = {}, {}
    for name, dev, dt in (("card", "cuda", None), ("cpu_bf16", "cpu", None),
                          ("cpu_f32", "cpu", torch.float32)):
        t0 = time.perf_counter()
        p = pack_params_for_decode(to(sub, dev, dt))
        shape = (n_layers, n_pages + 1, cfg.n_kv_heads, page, cfg.head_dim)
        pools = dict(
            k=torch.zeros(shape, dtype=torch.float8_e4m3fn, device=dev),
            v=torch.zeros(shape, dtype=torch.float8_e4m3fn, device=dev),
            k_s=torch.zeros(shape[:-1], device=dev), v_s=torch.zeros(shape[:-1], device=dev),
        )
        tokens = torch.zeros((1, C), dtype=torch.int64, device=dev)
        tokens[0, :n_valid] = torch.from_numpy(prompt)
        bt = torch.tensor([[0, n_pages]], dtype=torch.int32, device=dev)
        zero = torch.zeros(1, dtype=torch.int64, device=dev)
        logits_p = prefill_chunk_core(p, tokens, zero, zero + n_valid, pools, bt, cfg)
        # decode: row 0 continues the prompt (with the same token in every
        # run, so a near-tie in the argmax cannot split them), row 1 is an
        # inactive slot
        dtok = torch.tensor([[next_token], [0]], dtype=torch.int64, device=dev)
        dbt = torch.tensor([[0, n_pages], [n_pages, n_pages]], dtype=torch.int32, device=dev)
        lens = torch.tensor([n_valid + 1, 0], dtype=torch.int32, device=dev)
        _, logits_d = decode_core(p, dtok, pools, dbt, lens, cfg)
        # bucketed prefill rewrites page 0 with the same prompt's KV
        _, logits_b = prefill_core(p, tokens, n_valid, pools, bt[:, :1], cfg)
        runs[name] = tuple(x.float().cpu() for x in (logits_p, logits_d[:1], logits_b[None]))
        seconds[name] = time.perf_counter() - t0
    for i, what in enumerate(("prefill_logits", "decode_logits", "bucketed_prefill_logits")):
        ref = runs["cpu_f32"][i]
        err, lp = max_err(runs["card"][i], ref), max_err(runs["cpu_bf16"][i], ref)
        ok = bool(torch.isfinite(runs["card"][i]).all()) and err <= 2 * lp + 1e-5
        checks.add(f"engine_reference.{what}", ok, max_abs_err=err, tolerance=2 * lp + 1e-5,
                   shape=list(runs["card"][i].shape))
    return seconds


def serve(eng, cfg, seed):
    """Serve 8 greedy requests (prompts of 200-1500 tokens, 32 new tokens
    each) and time every engine step with CUDA events: a step that runs
    prefill (a chunk, or whole prompts with bucketed prefill) is a prefill
    step, the others decode steps. With chunked prefill the prefill rate is
    the prompt tokens over the prefill steps' time (those steps also decode
    the requests already active). Each request's time to first token runs
    from the moment all 8 are queued to the engine's `first_token_at`. With
    bucketed prefill the first step admits every prompt, one after the
    other, before it decodes: the last first token gives the prefill rate."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(200, 1501, 8)
    n_new = 32
    prompts = {i: rng.integers(0, cfg.vocab_size, int(n)).tolist() for i, n in enumerate(lens)}
    for rid, p in prompts.items():
        eng.add_request(rid, p, n_new)
    prefill_ms, decode_ms, decode_tokens = [], [], 0
    stats0 = dict(eng.stats)  # the counters also hold the warm-up request
    t0 = time.perf_counter()
    while eng.has_work():
        admitted0, chunks0 = eng.stats["requests_admitted"], eng.stats["prefill_chunks"]
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        emitted = eng.step()
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end)
        if eng.stats["requests_admitted"] > admitted0 or eng.stats["prefill_chunks"] > chunks0:
            prefill_ms.append(ms)
        else:
            decode_ms.append(ms)
            decode_tokens += sum(len(v) for v in emitted.values())
    wall = time.perf_counter() - t0
    for rid in prompts:
        toks = eng.results.get(rid)
        if toks is None or len(toks) != n_new:
            raise RuntimeError(f"request {rid}: expected {n_new} tokens, got {toks}")
        if not all(0 <= t < cfg.vocab_size for t in toks):
            raise RuntimeError(f"request {rid}: token out of the vocabulary: {toks}")
    prompt_tokens = int(lens.sum())
    ttft_ms = [1e3 * (eng.first_token_at[rid] - t0) for rid in prompts]
    out = dict(
        requests=len(prompts), prompt_tokens=prompt_tokens, new_tokens_per_request=n_new,
        prompt_lens=[int(x) for x in lens],
        prefill_steps=len(prefill_ms), decode_only_steps=len(decode_ms),
        prefill_tok_s=prompt_tokens / (sum(prefill_ms) / 1e3),
        decode_tok_s=decode_tokens / (sum(decode_ms) / 1e3) if decode_ms else None,
        prefill_step_ms=dict(p50=percentile(prefill_ms, 50), p90=percentile(prefill_ms, 90),
                             p99=percentile(prefill_ms, 99)),
        decode_step_ms=dict(p50=percentile(decode_ms, 50), p90=percentile(decode_ms, 90),
                            p99=percentile(decode_ms, 99)),
        ttft_ms=dict(p50=percentile(ttft_ms, 50), p90=percentile(ttft_ms, 90),
                     max=max(ttft_ms)),
        wall_s=wall, stats={k: v - stats0[k] for k, v in eng.stats.items()},
        allocator="native C++" if eng.pool.native else "Python",
    )
    if not eng.ecfg.prefill_chunk:
        out.update(buckets=[eng._bucket(int(n)) for n in lens],
                   prefill_tok_s=prompt_tokens / (max(ttft_ms) / 1e3))
    return out


def percentile(xs, p):
    return float(np.percentile(np.asarray(xs), p)) if xs else None


# the trace records no kernel that runs in its first moments: a step that
# launched its first kernels at once lost them (the api dense step's first K7
# and K8 calls), so the steps start this long after the trace
TRACE_SETTLE_S = 0.05


def profiled(fn, n_steps=1, groups=None):
    """Run fn n_steps times under torch.profiler, TRACE_SETTLE_S after it
    starts; the kernels' summed device time and launches per step (every
    kernel's, not the ten largest) and the ten largest, or None where the
    trace holds no device time. `groups` ({label: name substring}) adds each
    group's summed device time and launches per step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(TRACE_SETTLE_S)
        for _ in range(n_steps):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    total_us = sum(e.self_device_time_total for e in kernels)
    if total_us <= 0:
        return None
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    out = dict(
        steps=n_steps, device_ms_per_step=total_us / 1e3 / n_steps,
        launches_per_step=sum(e.count for e in kernels) / n_steps,  # every kernel's
        host_s=time.perf_counter() - t0,  # the profiled steps, the trace and its parse
        top=[dict(kernel=e.key[:90], ms_per_step=e.self_device_time_total / 1e3 / n_steps,
                  calls_per_step=e.count / n_steps) for e in top],
    )
    if groups:
        out["groups_ms_per_step"] = {
            label: sum(e.self_device_time_total for e in kernels if sub in e.key) / 1e3 / n_steps
            for label, sub in groups.items()}
        out["groups_calls_per_step"] = {
            label: sum(e.count for e in kernels if sub in e.key) / n_steps
            for label, sub in groups.items()}
    return out


# K1's kernels by route in a profiler trace
K1_GROUPS = dict(k1_decode="paged_decode_kernel", k1_combine="paged_combine_kernel",
                 k1_wgmma="paged_wgmma_kernel", k1_wmma="paged_attention_kernel")
# K3/K4's kernels by route, and the split-K reduction of the wgmma and WMMA routes
K3_GROUPS = dict(k3_decode="qmm_decode_kernel", k3_wgmma="qmm_wgmma_kernel",
                 k3_wmma="qmm_kernel", qmm_reduce="qmm_reduce_kernel")


def profile_decode(eng, cfg, seed, n_steps=3):
    """Device time of decode-only engine steps with 8 active requests, from
    a torch.profiler trace (`profiled`), with K1's and K3/K4's kernels by
    route. The engine prefills whole prompts (bucketed), so one step admits
    all 8."""
    rng = np.random.default_rng(seed + 2)
    n = eng.ecfg.max_batch
    for i in range(n):
        eng.add_request(1000 + i, rng.integers(0, cfg.vocab_size, 256).tolist(), n_steps + 2)
    eng.step()  # admit and prefill every request, and the first decode
    if len(eng.active) != n:
        raise RuntimeError(f"decode profile: {len(eng.active)} of {n} requests active")
    prof = profiled(eng.step, n_steps, groups=dict(K1_GROUPS, **K3_GROUPS, append=APPEND_KERNEL))
    eng.run()
    return prof


def profile_chunked_prefill(eng, cfg, seed):
    """The chunked prefill of serve's 8 prompts once more (the same tokens,
    one new token each) under a profiler trace: the device time by kernel
    and K1's on each route (its chunks take the Hopper chunk kernel, the
    requests decoding beside them the decode kernel and its combine), with
    K3's."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(200, 1501, 8)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist() for n in lens]

    def run():
        for i, prompt in enumerate(prompts):
            eng.add_request(3000 + i, prompt, 1)
        eng.run()

    prof = profiled(run, groups=dict(K1_GROUPS, k3="qmm", append=APPEND_KERNEL))
    return None if prof is None else dict(prof, prompt_tokens=int(lens.sum()))


def profile_admission(eng, cfg, seed):
    """One bucketed admission of the largest prompt of `serve` (1306 tokens
    at seed 0, bucket 2048) with one new token, so the step is the prefill
    alone: its CUDA-event time unprofiled, then its device time by kernel
    from a profiler trace of a second admission, with K3's share (every
    qmm kernel, the split-K reduction included)."""
    n = int(np.random.default_rng(seed).integers(200, 1501, 8).max())
    rng = np.random.default_rng(seed + 3)

    def admit():
        eng.add_request(2000 + len(eng.results), rng.integers(0, cfg.vocab_size, n).tolist(), 1)
        eng.step()
        if eng.has_work():
            raise RuntimeError("admission profile: the request did not finish in one step")

    admit()  # warm: the bucket's first call
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    admit()
    end.record()
    end.synchronize()
    prof = profiled(admit, groups=dict(k3="qmm", k7="flash_fwd", append=APPEND_KERNEL))
    out = dict(prompt_tokens=n, bucket=eng._bucket(n), step_ms=start.elapsed_time(end))
    if prof is not None:
        out.update(prof, k3_share=prof["groups_ms_per_step"]["k3"] / prof["device_ms_per_step"],
                   busy_share=prof["device_ms_per_step"] / out["step_ms"])
    return out


# ---- what the build made of K7 and K3 ----------------------------------------

def ptxas_usage(log_name, instantiation):
    """{instantiation: {registers, spill_bytes}} from the -Xptxas -v lines
    of build/<log_name>.log; `instantiation` names a mangled kernel, or
    None for kernels not reported."""
    from xf_flash_attention_cutlass_tpu_torch import _build

    with open(os.path.join(_build.BUILD_DIR, f"{log_name}.log")) as f:
        log = f.read()
    inst, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties for )(\w+)", line)
        if m:
            cur = instantiation(m.group(1))
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            inst.setdefault(cur, {})["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            inst.setdefault(cur, {})["registers"] = int(m.group(1))
    return inst


SASS_OPS = ("HGMMA", "UTMALDG", "UTMASTG", "HMMA")


def sass_by_function(lib_path):
    """{mangled kernel name: {op: count}} of the HGMMA (wgmma), UTMALDG (TMA
    load), UTMASTG (TMA store) and HMMA (mma.sync) instructions in
    `cuobjdump -sass` of a library."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    parts = re.split(r"Function : (\S+)", sass)
    return {name: {op: len(re.findall(rf"\b{op}\b", body)) for op in SASS_OPS}
            for name, body in zip(parts[1::2], parts[2::2])}


def qmm_instantiation(mangled):
    """'wgmma128_int8', 'decode_n8_fp8', 'bm16_fp8', 'bm64_bf16', ... (the
    kernel, its tile width or height or its tokens, the weight type) for a
    mangled qmm kernel name, else None (the split-K reduction)."""
    types = "(a|9fp8e4m3_t|13__nv_bfloat16)"
    m = (re.search(rf"qmm_(wgmma|decode)_kernelI{types}Li(\d+)E", mangled)
         or re.search(rf"qmm_(kernel)ILi(\d+)E{types}E", mangled))
    if m is None:
        return None
    kind = m.group(1)
    dtype, tile = (m.group(2), int(m.group(3))) if kind != "kernel" else (m.group(3),
                                                                          int(m.group(2)))
    dtype = {"a": "int8", "9fp8e4m3_t": "fp8", "13__nv_bfloat16": "bf16"}[dtype]
    if kind == "decode":
        return f"decode_n{8 * tile}_{dtype}"
    return f"{'wgmma' if kind == 'wgmma' else 'bm'}{tile}_{dtype}"


def qmm_build_report(checks, lib_path):
    """Registers and spill bytes of every qmm instantiation (build/qmm.log)
    and the SASS counts of each. Checks that each wgmma instantiation holds
    HGMMA and UTMALDG and no HMMA, that each of the six decode ones holds
    HMMA (mma.sync) and UTMALDG, no HGMMA and no spill, and that the WMMA
    ones keep their HMMA; and that the occupancy calculator gives every
    decode instantiation the resident blocks an SM its split plan counts."""
    from xf_flash_attention_cutlass_tpu_torch.quant import linear

    inst = ptxas_usage("qmm", qmm_instantiation)
    for name, counts in sass_by_function(lib_path).items():
        label = qmm_instantiation(name)
        if label is not None:
            inst.setdefault(label, {}).update(counts)
    print(json.dumps({"qmm_build": inst}), flush=True)
    wgmma = {n: r for n, r in inst.items() if n.startswith("wgmma")}
    decode = {n: r for n, r in inst.items() if n.startswith("decode")}
    wmma = {n: r for n, r in inst.items() if n.startswith("bm")}
    checks.add("qmm.decode_sass_mma_sync_tma_no_wgmma",
               len(decode) == 6 and all(r.get("HMMA", 0) > 0 and r.get("UTMALDG", 0) > 0
                                        and r.get("HGMMA", 1) == 0 for r in decode.values()),
               sass={n: {op: r.get(op) for op in SASS_OPS} for n, r in decode.items()})
    checks.add("qmm.decode_no_spills",
               len(decode) == 6 and all(r.get("spill_bytes") == 0 for r in decode.values()),
               registers={n: r.get("registers") for n, r in decode.items()},
               spill_bytes={n: r.get("spill_bytes") for n, r in decode.items()})
    occ = {f"{str(dt).split('.')[-1]}_n{rows}": linear.qmm_decode_blocks_per_sm(dt, rows)
           for dt in (torch.int8, torch.float8_e4m3fn, torch.bfloat16) for rows in (8, 16)}
    checks.add("qmm.decode_resident_blocks",
               all(v == linear.QMM_DECODE_BLOCKS_PER_SM for v in occ.values()),
               blocks_per_sm=occ, expected=linear.QMM_DECODE_BLOCKS_PER_SM)
    checks.add("qmm.wgmma_sass_wgmma_tma_no_mma_sync",
               len(wgmma) == 6 and all(r.get("HGMMA", 0) > 0 and r.get("UTMALDG", 0) > 0
                                       and r.get("HMMA", 1) == 0 for r in wgmma.values()),
               sass={n: {op: r.get(op) for op in SASS_OPS} for n, r in wgmma.items()})
    checks.add("qmm.wmma_sass_keeps_mma_sync",
               len(wmma) == 6 and all(r.get("HMMA", 0) > 0 for r in wmma.values()),
               hmma={n: r.get("HMMA") for n, r in wmma.items()})
    return inst


_K7_NAME = re.compile(r"flash_fwd_kernelI(\w+?)Li(\d+)ELb([01])E")


def k7_instantiation(mangled):
    """'bf16_d128_plain' for a mangled flash_fwd_kernel name (the
    option-free instantiation is 'plain', the other 'options'), else None."""
    m = _K7_NAME.search(mangled)
    if m is None:
        return None
    dtype = "bf16" if "bfloat16" in m.group(1) else "f16"
    return f"{dtype}_d{m.group(2)}_{'options' if m.group(3) == '1' else 'plain'}"


def k7_build_report(checks, lib_path):
    """Registers and spill bytes of every K7 instantiation, from the
    -Xptxas -v lines of the build log (build/flash_fwd.log), and the counts
    of HGMMA (wgmma), UTMALDG (TMA loads) and HMMA (mma.sync) instructions in
    `cuobjdump -sass` of the library. Checks HGMMA > 0, UTMALDG > 0, HMMA = 0
    and no spill in the option-free instantiations."""
    inst = ptxas_usage("flash_fwd", k7_instantiation)
    counts = {op: sum(c[op] for c in sass_by_function(lib_path).values()) for op in SASS_OPS}
    report = dict(instantiations=inst, sass=counts)
    print(json.dumps({"flash_fwd_build": report}), flush=True)
    checks.add("flash_fwd.sass_wgmma_tma_no_mma_sync",
               counts["HGMMA"] > 0 and counts["UTMALDG"] > 0 and counts["HMMA"] == 0, **counts)
    plain = {n: r for n, r in inst.items() if n.endswith("_plain")}
    checks.add("flash_fwd.option_free_no_spills",
               len(plain) == 4 and all(r.get("spill_bytes") == 0 for r in plain.values()),
               spill_bytes={n: r.get("spill_bytes") for n, r in plain.items()})
    return report


_K8_NAME = re.compile(r"flash_probs_kernelI(\w+?)Li(\d+)ELb([01])E")


def probs_instantiation(mangled):
    """'bf16_d128_tma_store' for a mangled flash_probs_kernel name (the
    instantiation for sk % 4 != 0 is 'element_store'), else None."""
    m = _K8_NAME.search(mangled)
    if m is None:
        return None
    dtype = "bf16" if "bfloat16" in m.group(1) else "f16"
    return f"{dtype}_d{m.group(2)}_{'tma_store' if m.group(3) == '1' else 'element_store'}"


def probs_build_report(checks, lib_path):
    """Registers and spill bytes of every K8 instantiation (build/
    flash_probs.log) and its HGMMA, UTMALDG, UTMASTG and HMMA counts. Checks
    that all eight hold HGMMA and UTMALDG and no HMMA, that the TMA-store
    ones hold UTMASTG, and that none spills."""
    inst = ptxas_usage("flash_probs", probs_instantiation)
    sass = {probs_instantiation(n): c for n, c in sass_by_function(lib_path).items()
            if probs_instantiation(n)}
    report = dict(instantiations=inst, sass=sass)
    print(json.dumps({"flash_probs_build": report}), flush=True)
    checks.add("flash_probs.sass_wgmma_tma_no_mma_sync",
               len(sass) == 8 and all(c["HGMMA"] > 0 and c["UTMALDG"] > 0 and c["HMMA"] == 0
                                      for c in sass.values())
               and all(c["UTMASTG"] > 0 for n, c in sass.items() if n.endswith("_tma_store")),
               sass=sass)
    checks.add("flash_probs.no_spills",
               len(inst) == 8 and all(r.get("spill_bytes") == 0 for r in inst.values()),
               spill_bytes={n: r.get("spill_bytes") for n, r in inst.items()})
    return report


_BWD_NAME = re.compile(r"flash_bwd_(dkv|dq)_kernelI(\w+?)Li(\d+)E(?:Lb([01])E)?Lb([01])E")


def bwd_instantiation(mangled):
    """'dkv_bf16_d128_plain', 'fused_f16_d64_options', 'dq_bf16_d128_plain',
    ... for a mangled K9-K11 kernel name, else None."""
    m = _BWD_NAME.search(mangled)
    if m is None:
        return None
    kind = "dq" if m.group(1) == "dq" else ("fused" if m.group(4) == "1" else "dkv")
    dtype = "bf16" if "bfloat16" in m.group(2) else "f16"
    return f"{kind}_{dtype}_d{m.group(3)}_{'options' if m.group(5) == '1' else 'plain'}"


def flash_bwd_build_report(checks, lib_path):
    """Registers and spill bytes of every K9-K11 instantiation
    (build/flash_bwd.log) and the SASS counts of each, with any ptxas line
    that says wgmma was serialized. Checks that every K9, K10 and K11
    instantiation holds HGMMA and UTMALDG and no HMMA (mma.sync), and that
    the option-free ones spill nothing."""
    from xf_flash_attention_cutlass_tpu_torch import _build

    inst = ptxas_usage("flash_bwd", bwd_instantiation)
    for name, counts in sass_by_function(lib_path).items():
        label = bwd_instantiation(name)
        if label is not None:
            inst.setdefault(label, {}).update(counts)
    with open(os.path.join(_build.BUILD_DIR, "flash_bwd.log")) as f:
        serialized = [ln.strip() for ln in f if "serialized" in ln]
    print(json.dumps({"flash_bwd_build": dict(instantiations=inst, serialized=serialized)}),
          flush=True)
    dkv = {n: r for n, r in inst.items() if not n.startswith("dq")}
    dq = {n: r for n, r in inst.items() if n.startswith("dq")}
    checks.add("flash_bwd.dkv_sass_wgmma_tma_no_mma_sync",
               len(dkv) == 16 and all(r.get("HGMMA", 0) > 0 and r.get("UTMALDG", 0) > 0
                                      and r.get("HMMA", 1) == 0 for r in dkv.values()),
               sass={n: {op: r.get(op) for op in SASS_OPS} for n, r in dkv.items()})
    plain = {n: r.get("spill_bytes") for n, r in dkv.items() if n.endswith("_plain")}
    checks.add("flash_bwd.dkv_option_free_no_spills",
               len(plain) == 8 and all(b == 0 for b in plain.values()), spill_bytes=plain)
    checks.add("flash_bwd.dq_sass_wgmma_tma_no_mma_sync",
               len(dq) == 8 and all(r.get("HGMMA", 0) > 0 and r.get("UTMALDG", 0) > 0
                                    and r.get("HMMA", 1) == 0 for r in dq.values()),
               sass={n: {op: r.get(op) for op in SASS_OPS} for n, r in dq.items()})
    plain = {n: r.get("spill_bytes") for n, r in dq.items() if n.endswith("_plain")}
    checks.add("flash_bwd.dq_option_free_no_spills",
               len(plain) == 4 and all(b == 0 for b in plain.values()), spill_bytes=plain)
    return dict(instantiations=inst, serialized=serialized)


_K1_TYPES = {"a": "int8", "9fp8e4m3_t": "fp8", "13__nv_bfloat16": "bf16"}
_K1_NAME = re.compile(r"paged_(wgmma|attention|decode)_kernelI(a|9fp8e4m3_t|13__nv_bfloat16)"
                      r"Li(\d+)E(?:Li(\d+)E)?(?:Lb([01])E)?")
_K1_COMBINE = re.compile(r"paged_combine_kernelILi(\d+)E")


def k1_instantiation(mangled):
    """'wgmma_fp8_d128' for a mangled Hopper K1 chunk kernel name,
    'decode_int8_d64_n8' for a decode one (n: its 8 or 16 query rows), each
    with '_options' for its options instantiation; 'wmma_int8_d64_rt32_options'
    or '..._plain' for a WMMA one, 'combine_d128' for the combine kernel,
    else None."""
    m = _K1_COMBINE.search(mangled)
    if m is not None:
        return f"combine_d{m.group(1)}"
    m = _K1_NAME.search(mangled)
    if m is None:
        return None
    name = f"{'wmma' if m.group(1) == 'attention' else m.group(1)}_{_K1_TYPES[m.group(2)]}" \
           f"_d{m.group(3)}"
    if m.group(1) == "decode":
        name += f"_n{8 * int(m.group(4))}"
    elif m.group(1) == "attention":
        return name + f"_rt{m.group(4)}_{'options' if m.group(5) == '1' else 'plain'}"
    return name + ("_options" if m.group(5) == "1" else "")


def paged_build_report(checks, lib_path):
    """Registers and spill bytes of every K1 instantiation
    (build/paged_attention.log) and the SASS counts of each. Checks that the
    twelve Hopper chunk instantiations (six option-free, six with the
    options) hold HGMMA and UTMALDG, no HMMA and no spill, that the 24
    decode ones (twelve of each) hold HMMA (mma.sync) and UTMALDG and spill
    nothing, that the two combine ones spill nothing, that the 24 WMMA ones
    (every one still reached: pages of no whole TMA box, with and without
    the options) keep their HMMA, and that every decode instantiation keeps
    the two resident blocks an SM its split plan counts."""
    inst = ptxas_usage("paged_attention", k1_instantiation)
    for name, counts in sass_by_function(lib_path).items():
        label = k1_instantiation(name)
        if label is not None:
            inst.setdefault(label, {}).update(counts)
    print(json.dumps({"paged_build": inst}), flush=True)
    kinds = {k: {n: r for n, r in inst.items() if n.startswith(k)}
             for k in ("wgmma", "wmma", "decode", "combine")}
    wgmma, decode = kinds["wgmma"], kinds["decode"]
    checks.add("paged_attention.wgmma_sass_wgmma_tma_no_mma_sync",
               len(wgmma) == 12 and all(r.get("HGMMA", 0) > 0 and r.get("UTMALDG", 0) > 0
                                       and r.get("HMMA", 1) == 0 for r in wgmma.values()),
               sass={n: {op: r.get(op) for op in SASS_OPS} for n, r in wgmma.items()})
    checks.add("paged_attention.wgmma_no_spills",
               len(wgmma) == 12 and all(r.get("spill_bytes") == 0 for r in wgmma.values()),
               spill_bytes={n: r.get("spill_bytes") for n, r in wgmma.items()})
    checks.add("paged_attention.decode_sass_mma_sync_tma",
               len(decode) == 24 and all(r.get("HMMA", 0) > 0 and r.get("UTMALDG", 0) > 0
                                         for r in decode.values()),
               sass={n: {op: r.get(op) for op in SASS_OPS} for n, r in decode.items()})
    spills = {n: r.get("spill_bytes") for k in ("decode", "combine") for n, r in kinds[k].items()}
    checks.add("paged_attention.decode_and_combine_no_spills",
               len(spills) == 26 and all(b == 0 for b in spills.values()), spill_bytes=spills)
    checks.add("paged_attention.wmma_sass_keeps_mma_sync",
               len(kinds["wmma"]) == 24 and all(r.get("HMMA", 0) > 0
                                                for r in kinds["wmma"].values()),
               hmma={n: r.get("HMMA") for n, r in kinds["wmma"].items()})
    # the decode route's split heuristic counts DECODE_BLOCKS_PER_SM blocks an
    # SM: the occupancy calculator must agree for every instantiation
    from xf_flash_attention_cutlass_tpu_torch.ops import paged

    occ = {f"{str(dt).split('.')[-1]}_d{d}_n{n}{'_options' if o else ''}":
           paged.decode_blocks_per_sm(dt, d, n, o)
           for dt in (torch.float8_e4m3fn, torch.int8, torch.bfloat16) for d in (64, 128)
           for n in (8, 16) for o in (False, True)}
    checks.add("paged_attention.decode_resident_blocks",
               all(v == paged.DECODE_BLOCKS_PER_SM for v in occ.values()),
               blocks_per_sm=occ, expected=paged.DECODE_BLOCKS_PER_SM)
    return inst


# ---- main ---------------------------------------------------------------------

_PKG = "xf_flash_attention_cutlass_tpu_torch/csrc/"
_TPU = "xf_flash_attention_cutlass_tpu/"
KERNELS = {  # launch-counter name: (source, TPU kernel it replaces)
    "paged_attention.decode": (_PKG + "paged_attention.cu", _TPU + "ops/paged.py:97"),
    "paged_attention.combine": (_PKG + "paged_attention.cu", _TPU + "ops/paged.py:97"),
    "paged_attention.decode.options": (_PKG + "paged_attention.cu", _TPU + "ops/paged.py:97"),
    "paged_attention.decode.wmma": (_PKG + "paged_attention.cu", _TPU + "ops/paged.py:97"),
    "paged_attention.prefill.wgmma": (_PKG + "paged_attention.cu", _TPU + "ops/paged.py:97"),
    "paged_attention.prefill.options": (_PKG + "paged_attention.cu", _TPU + "ops/paged.py:97"),
    "paged_append.decode": (_PKG + "paged_append.cu", _TPU + "ops/paged_append.py:68"),
    "paged_append.prefill": (_PKG + "paged_append.cu", _TPU + "ops/paged_append.py:166"),
    "qmm.stacked.decode": (_PKG + "qmm.cu", _TPU + "quant/linear.py:70"),
    "qmm.stacked.bm16": (_PKG + "qmm.cu", _TPU + "quant/linear.py:70"),
    "qmm.stacked.wgmma": (_PKG + "qmm.cu", _TPU + "quant/linear.py:70"),
    "qmm.stacked.bm64": (_PKG + "qmm.cu", _TPU + "quant/linear.py:70"),
    "qmm.single.decode": (_PKG + "qmm.cu", _TPU + "quant/linear.py:48"),
    "qmm.single.bm16": (_PKG + "qmm.cu", _TPU + "quant/linear.py:48"),
    "qmm.single.wgmma": (_PKG + "qmm.cu", _TPU + "quant/linear.py:48"),
    "flash_fwd": (_PKG + "flash_fwd.cu", _TPU + "ops/flash_fwd.py:100"),
    "flash_probs": (_PKG + "flash_probs.cu", _TPU + "ops/flash_fwd.py:379"),
    "flash_bwd.dq": (_PKG + "flash_bwd.cu", _TPU + "ops/flash_bwd.py:228"),
    "flash_bwd.dkv": (_PKG + "flash_bwd.cu", _TPU + "ops/flash_bwd.py:284"),
    "flash_bwd.fused": (_PKG + "flash_bwd.cu", _TPU + "ops/flash_bwd.py:156"),
}
# the kernels each main path must launch (and it may call no plain version);
# the engine's decode splits (paged_plan: 4 at b = 8) run the combine kernel
PATHS = {
    "serve_chunked": ["paged_attention.decode", "paged_attention.combine",
                      "paged_attention.prefill.wgmma", "paged_append.decode",
                      "paged_append.prefill", "qmm.stacked.decode", "qmm.stacked.wgmma",
                      "qmm.single.decode"],
    "serve_bucketed": ["flash_fwd", "paged_append.prefill", "paged_attention.decode",
                       "paged_attention.combine", "paged_append.decode", "qmm.stacked.decode",
                       "qmm.stacked.wgmma", "qmm.single.decode"],
    "train": ["flash_fwd", "flash_bwd.dq", "flash_bwd.dkv", "flash_bwd.fused"],
    "api": ["flash_fwd", "flash_probs", "flash_bwd.dq", "flash_bwd.dkv",
            "paged_attention.decode", "paged_attention.decode.options",
            "paged_attention.prefill.wgmma", "paged_attention.prefill.options"],
}
# kernels a main path must not launch: serving decodes on K1's and K3/K4's
# decode kernels, and the api path's options take K1's Hopper kernels
NOT_ON_PATH = {"serve_chunked": ["paged_attention.decode.wmma", "qmm.stacked.bm16",
                                 "qmm.single.bm16"],
               "serve_bucketed": ["paged_attention.decode.wmma", "qmm.stacked.bm16",
                                  "qmm.single.bm16"],
               "api": ["paged_attention.decode.wmma", "paged_attention.prefill.wmma"]}


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def drive(path, fn):
    """Run one main path with the launch counters cleared just before and
    read just after; raise if a kernel of the path never launched or a
    plain version ran. Returns (fn's result, the launch counts)."""
    from xf_flash_attention_cutlass_tpu_torch import _build

    torch.cuda.synchronize()
    _build.LAUNCHES.clear()
    _build.PLAIN_CALLS.clear()
    result = fn()
    torch.cuda.synchronize()
    launches, plain_calls = dict(_build.LAUNCHES), dict(_build.PLAIN_CALLS)
    print(json.dumps({path: dict(launches=launches, plain_calls=plain_calls)}), flush=True)
    missing = [k for k in PATHS[path] if launches.get(k, 0) == 0]
    if missing:
        raise RuntimeError(f"{path}: kernels of the path never launched: {missing}")
    stray = [k for k in NOT_ON_PATH.get(path, ()) if launches.get(k, 0)]
    if stray:
        raise RuntimeError(f"{path}: kernels off the path launched: {stray}")
    if any(plain_calls.values()):
        raise RuntimeError(f"{path}: plain versions ran on the path: {plain_calls}")
    return result, launches


def main():
    args = parse_args()
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py: no CUDA device; the port's kernels run only on the card")
    from xf_flash_attention_cutlass_tpu_torch import _build
    from xf_flash_attention_cutlass_tpu_torch.models.llama import (
        LlamaConfig,
        init_params,
        quantize_params,
    )
    from xf_flash_attention_cutlass_tpu_torch.serve.engine import DecodeEngine, EngineConfig

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 oracles in full f32
    torch.backends.cudnn.allow_tf32 = False
    report = dict(device=torch.cuda.get_device_name(0), smi=nvidia_smi(),
                  torch=torch.__version__, cuda=torch.version.cuda)
    print(json.dumps(report), flush=True)
    phase_s, t_mark = {}, [t_start]  # seconds of each phase, host clock

    def mark(phase):
        now = time.perf_counter()
        phase_s[phase], t_mark[0] = now - t_mark[0], now

    # 1. build
    t0 = time.perf_counter()
    libs = _build.build_all()
    report["build_s"] = time.perf_counter() - t0
    mark("build")
    print(f"build: {report['build_s']:.1f} s for {len(_build.SOURCES)} kernel sources", flush=True)
    checks = Checks()
    report["flash_fwd_build"] = k7_build_report(checks, libs["flash_fwd"])
    report["qmm_build"] = qmm_build_report(checks, libs["qmm"])
    report["flash_bwd_build"] = flash_bwd_build_report(checks, libs["flash_bwd"])
    report["paged_build"] = paged_build_report(checks, libs["paged_attention"])
    report["flash_probs_build"] = probs_build_report(checks, libs["flash_probs"])

    # 2. kernels against their plain versions, at the main paths' shapes
    cfg = LlamaConfig.llama8b()
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    timer = Timer()
    measured = {}
    for kv_dtype in (torch.float8_e4m3fn, torch.int8, torch.bfloat16):
        for phase in ("decode", "prefill"):
            r = check_paged_attention(gen, timer, checks, kv_dtype, phase, cfg)
            if kv_dtype == torch.float8_e4m3fn:
                measured["paged_attention.decode" if phase == "decode"
                         else "paged_attention.prefill.wgmma"] = r
            r = check_paged_append(gen, timer, checks, kv_dtype, phase, cfg)
            if kv_dtype == torch.float8_e4m3fn:
                measured[f"paged_append.{phase}"] = r
    d, hd = cfg.dim, cfg.head_dim
    layer_shapes = [(d, cfg.n_heads * hd), (d, cfg.n_kv_heads * hd), (d, cfg.n_kv_heads * hd),
                    (cfg.n_heads * hd, d), (d, cfg.ffn_dim), (d, cfg.ffn_dim), (cfg.ffn_dim, d)]
    distinct = sorted(set(layer_shapes))
    # K3 at decode widths (m = 1, 8, 16: the decode kernel), one layer's
    # projections timed, beside the WMMA bm16 kernel forced onto the same shapes
    for kind, name in ((None, "qmm.stacked.decode"), ("bm16", "qmm.stacked.bm16")):
        r1, r8, r16 = (check_qmm(gen, timer, checks, torch.int8, m, layer_shapes, True,
                                 kind=kind) for m in QMM_DECODE_M)
        measured[name] = dict(r8, other_shapes={"m1": r1, "m16": r16})
    # and checked, untimed: int8, fp8 and bf16 without scale, stacked and single
    for w_dtype in (torch.int8, torch.float8_e4m3fn, torch.bfloat16):
        for stacked in (True, False):
            for m in QMM_DECODE_M:
                if not (w_dtype == torch.int8 and stacked):  # checked above
                    check_qmm(gen, timer, checks, w_dtype, m, distinct, stacked, timed=False)
    check_qmm_decode_repeat(gen, checks)
    # K3 at prefill widths: the wgmma kernel at m = 256 (a chunk) and 2048 (the
    # largest bucket), timed beside the WMMA kernel on the same shapes
    for kind, name in ((None, "qmm.stacked.wgmma"), ("bm64", "qmm.stacked.bm64")):
        r256, r2048 = (check_qmm(gen, timer, checks, torch.int8, m, layer_shapes, True,
                                 kind=kind) for m in (256, 2048))
        measured[name] = dict(r256, other_shapes={"m2048": r2048})
    # and checked, untimed: bf16 without scale, int8 and fp8, stacked and
    # single, at ragged and prefill widths, and the buckets between
    for w_dtype in (torch.bfloat16, torch.int8, torch.float8_e4m3fn):
        for stacked in (True, False):
            for m in QMM_PREFILL_M:
                if not (w_dtype == torch.int8 and stacked and m in (256, 2048)):  # timed above
                    check_qmm(gen, timer, checks, w_dtype, m, distinct, stacked, timed=False)
    for m in (512, 1024):
        check_qmm(gen, timer, checks, torch.int8, m, layer_shapes, True, timed=False)
    check_qmm_conversion(checks)
    report["qmm_host_us"] = qmm_host_us(gen)
    print(json.dumps({"qmm_host_us": report["qmm_host_us"]}), flush=True)
    # the int8 lm_head (K4): m = 1 after a chunk and 8 per decode step (the
    # decode kernel, beside bm16 on the same shapes), 256 at prefill width
    # (the wgmma kernel)
    for kind, name in ((None, "qmm.single.decode"), ("bm16", "qmm.single.bm16")):
        r1, r8 = (check_qmm(gen, timer, checks, torch.int8, m, [(d, cfg.vocab_size)], False,
                            kind=kind) for m in (1, 8))
        measured[name] = dict(r8, other_shapes={"m1": r1})
    measured["qmm.single.wgmma"] = check_qmm(gen, timer, checks, torch.int8, 256,
                                             [(d, cfg.vocab_size)], False)
    report["qmm_decode_times"] = qmm_decode_times(measured)
    print(json.dumps({"qmm_decode_times": report["qmm_decode_times"]}), flush=True)
    measured["paged_attention.combine"] = check_paged_combine(
        gen, timer, checks, cfg, measured["paged_attention.decode"]["splits"])
    check_other_shapes(gen, checks)
    check_paged_route_shapes(gen, checks)
    check_bucket_append(gen, checks, cfg)
    report["page32_append"] = check_page32_append(gen, timer, checks, cfg)
    report["append_bucket2048"] = check_append_widths(gen, timer, checks, cfg)
    print(json.dumps({"append_bucket2048": report["append_bucket2048"]}), flush=True)
    measured.update(check_flash(gen, timer, checks, cfg))
    report["flash_fwd_bshd_kernels"] = check_flash_fwd_tiling(gen, checks, cfg)
    check_flash_bwd_tiling(gen, checks, cfg)
    check_flash_bwd_views(gen, checks, cfg)
    report["attention_block_kernels"] = check_attention_block_launches(gen, checks, cfg)
    report["sdpa_fwd_bwd_ms"] = measured["flash_bwd.fused"]["library_fwd_bwd_ms"]
    # the option-free kernels against the options' kernels (ALiBi of slope
    # 0, same result) on the same work: what the second instantiation saves
    timed = dict(measured)
    timed.update({f"flash_fwd.{n}": r for n, r in measured["flash_fwd"]["other_shapes"].items()})
    report["general_instantiation"] = {
        n: dict(ms=r["ms"], ms_general=r["ms_general"], ratio=r["ms_general"] / r["ms"])
        for n, r in timed.items() if "ms_general" in r}
    print(json.dumps({"general_instantiation": report["general_instantiation"]}), flush=True)
    mark("kernels")
    # the API's options, at the api path's shapes
    measured["flash_probs"] = check_api_dense(gen, timer, checks, cfg)
    check_probs_cases(gen, checks)
    report["probs_shares"] = probs_shares(gen, timer, cfg, serving_prompt_lens(args.seed))
    print(json.dumps({"probs_shares": report["probs_shares"]}), flush=True)
    measured["flash_probs"]["device_ms"] = report["probs_shares"]["api"]["device_ms"]
    options = check_paged_extras(gen, timer, checks, cfg)
    measured.update(options)
    report["api_kernels"] = dict(
        flash_probs=measured["flash_probs"],
        flash_fwd_packed=check_api_packed(gen, timer, checks, cfg,
                                          serving_prompt_lens(args.seed)),
        paged_attention_options=options)
    print(json.dumps({"api_kernels": report["api_kernels"]}), flush=True)
    checks.raise_on_failure("kernel comparison")
    del timer
    torch.cuda.empty_cache()
    mark("api_kernels")
    paths = {}

    # 3. training: Llama-8B widths and all 32 layers in bf16, plain SGD
    torch.cuda.reset_peak_memory_stats()
    (ok, training), paths["train"] = drive("train", lambda: train(gen, cfg, args.seed))
    checks.add("train.loss_falls", ok, losses=training["losses"])
    report["training"] = training
    print(json.dumps({"training": training}), flush=True)
    checks.raise_on_failure("training")
    mark("train")

    # 4. serving: Llama-8B, all 32 layers, INT8 weights, FP8 paged KV, first
    # with 256-token chunked prefill, then with bucketed prefill (the
    # default), the same 8 requests each time; then a profiled decode window
    t0 = time.perf_counter()
    params = quantize_params(init_params(gen, cfg))
    torch.cuda.synchronize()
    report["init_s"] = time.perf_counter() - t0
    report["reference_check_s"] = reference_check(params, cfg, checks, args.seed)
    checks.raise_on_failure("engine reference check")
    mark("serve_init_and_reference_check")
    ecfg = EngineConfig(kv_quant="fp8_e4m3", page_size=256, num_pages=256, max_seq=4096,
                        max_batch=8, prefill_chunk=256)
    eng = DecodeEngine(params, cfg, ecfg)
    eng.add_request(-1, list(range(300)), 2)  # warm-up request, not counted
    eng.run()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    serving, paths["serve_chunked"] = drive("serve_chunked", lambda: serve(eng, cfg, args.seed))
    serving["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    serving["launches"] = paths["serve_chunked"]
    report["serving"] = serving
    print(json.dumps({"serving": serving}), flush=True)
    report["chunked_prefill_profile"] = profile_chunked_prefill(eng, cfg, args.seed)
    print(json.dumps({"chunked_prefill_profile": report["chunked_prefill_profile"]}), flush=True)
    del eng
    torch.cuda.empty_cache()
    mark("serve_chunked")

    # the kernels are warm from the chunked engine: no warm-up request here
    eng = DecodeEngine(params, cfg, dataclasses.replace(ecfg, prefill_chunk=None))
    del params
    bucketed, paths["serve_bucketed"] = drive("serve_bucketed",
                                              lambda: serve(eng, cfg, args.seed))
    bucketed["launches"] = paths["serve_bucketed"]
    report["serving_bucketed"] = bucketed
    print(json.dumps({"serving_bucketed": bucketed}), flush=True)
    mark("serve_bucketed")
    report["admission_profile"] = profile_admission(eng, cfg, args.seed)
    print(json.dumps({"admission_profile": report["admission_profile"]}), flush=True)
    prof = profile_decode(eng, cfg, args.seed)
    if prof is not None:  # device busy share of a decode-only step
        prof["busy_share_of_p50_step"] = (prof["device_ms_per_step"]
                                          / bucketed["decode_step_ms"]["p50"])
    report["decode_profile"] = prof
    print(json.dumps({"decode_profile": prof}), flush=True)
    # the decode step's projections on the decode kernel, its splits summed
    # inside it: no reduction launch and no WMMA kernel
    calls = (prof or {}).get("groups_calls_per_step", {})
    checks.add("decode_profile.k3_decode_without_reduction",
               calls.get("k3_decode", 0) > 0 and calls.get("qmm_reduce", 1) == 0
               and calls.get("k3_wmma", 1) == 0,
               calls_per_step={k: calls.get(k) for k in K3_GROUPS})
    checks.raise_on_failure("decode profile")
    del eng
    torch.cuda.empty_cache()
    mark("decode_profile")

    # 5. the public API at Llama-8B attention width
    (res, api_s, calls, copies), paths["api"] = drive("api", lambda: api_path(gen, cfg, args.seed))
    check_api_outputs(checks, res, cfg)
    del res
    checks.raise_on_failure("api")
    report["api"] = dict(first_call_s=api_s, launches=paths["api"],
                         warm=time_api_steps(calls, copies))
    print(json.dumps({"api": report["api"]}), flush=True)
    del calls, copies
    mark("api")

    # 6. the kernels line, the card, the result
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        r = measured[name]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=sum(p.get(name, 0) for p in paths.values()),
            max_abs_err=r["err"], tolerance=r["tol"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound"][0],
            bound_by=r["bound"][1], library_ms=r["library_ms"],
        ))
        # K1: the WMMA kernel and the Hopper chunk kernel on the same inputs, SDPA
        # over every page of the table, the split count, the options' calls
        # beside the option-free one (and ALiBi of slope 0) on the same inputs;
        # the append kernel and K8 on device (a profiler trace)
        for extra in ("wmma_ms", "wgmma_ms", "library_ms_all_pages", "splits", "device_ms",
                      "ms_no_options", "ms_alibi0", "wmma_splits"):
            if extra in r:
                kernels[-1][extra] = r[extra]
        if "other_shapes" in r:  # K7 at the training shape and at s = 2048
            kernels[-1]["other_shapes"] = {
                shape: dict(ms=o["ms"], plain_ms=o["plain_ms"], bound_ms=o["bound"][0],
                            bound_by=o["bound"][1], library_ms=o["library_ms"],
                            max_abs_err=o["err"], tolerance=o["tol"])
                for shape, o in r["other_shapes"].items()}
    report["kernels"], report["checks"] = kernels, checks.cases
    report["phase_s"], report["total_s"] = phase_s, time.perf_counter() - t_start
    print(json.dumps({"phase_s": phase_s}), flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(report["smi"], flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
