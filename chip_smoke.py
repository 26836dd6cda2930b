"""On-card smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py [--seed N] [--out DIR]

Phases, each of which raises (exit code != 0) when it fails:

1. Build every CUDA kernel from xf_flash_attention_cutlass_tpu_torch/csrc
   (one nvcc per source, in parallel) and print the seconds it took.
2. Hold each kernel against its plain PyTorch version on the card, at the
   shapes the main paths give it (Llama-8B widths), and time the kernel,
   the plain version and, where one exists, a PyTorch library call that
   computes the same function (a yardstick only; the port never calls it).
   Bucketed prefill's shapes are all covered: K3 at m = 256-2048, K5
   appending a whole bucket at position 0 through a trash-tailed block-table
   row, K7 at every bucket. The dense flash kernels are also held against a
   dense f32 oracle (utils/testing.py): K7 at the bucketed-prefill and
   training shapes under the 2x rule, K9/K10/K11 at the training shape under
   the 3x rule. Shapes off the paths (ragged matmuls, page 16 and 32,
   head_dim 64, unaligned lengths, window, softcap, segment ids, GQA 4:1)
   are checked too, untimed.
3. Train: Llama-8B widths, all 32 layers, bf16, one 1024-token batch from
   the seed, three plain SGD steps through K7 forward and K9/K10 backward
   and one through K11; every loss finite and below the one before.
4. Serve Llama-8B (all 32 layers, full width, random weights from the seed)
   with INT8 weights and an FP8-e4m3 paged KV cache through DecodeEngine:
   first a reference check of the chunk, decode and bucketed prefill cores
   against the plain versions on the CPU (2 layers), then 8 greedy requests
   with 256-token chunked prefill, the same 8 requests with bucketed
   prefill (K7), and a profiled decode window.
   Each main path (training, chunked and bucketed serving) runs with the
   launch counters cleared just before and read just after, to show that
   every kernel of the path ran and no plain version did.
5. Print the seconds of each phase, the `kernels` JSON line, the card's
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
    call) and are queued whole behind a spin of the card."""

    def __init__(self):
        self.flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")

    def ms(self, fn, reps=REPS) -> float:
        fn()  # warm-up: first-launch costs stay out of the number
        torch.cuda.synchronize()
        pairs = []
        for _ in range(reps):
            torch.cuda._sleep(SLEEP_CYCLES)
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            pairs.append((start, end))
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in pairs) / reps


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


def check_paged_attention(gen, timer, checks, kv_dtype, phase, cfg):
    """K1 at the engine's shapes: decode b=8, sq=1 over kv_lens of the
    serving prompts, or one 256-token chunk at b=1. The tolerance is the 2x
    rule's: twice the error of the dense oracle in the working dtype against
    the dense float32 oracle (utils/testing.py), plus 1e-5. Both the
    kernel's distance from its plain version and its error against the f32
    oracle must stay within it."""
    from xf_flash_attention_cutlass_tpu_torch.ops.paged import (
        paged_attention,
        paged_attention_ref,
        resolve_num_splits,
    )
    from xf_flash_attention_cutlass_tpu_torch.utils.testing import paged_attention_oracle

    h, h_k, d, page, max_pages = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, 256, 16
    b, sq = (8, 1) if phase == "decode" else (1, 256)
    n_pages = 64
    kp, vp, ks, vs = kv_pools(gen, kv_dtype, 2, n_pages, h_k, page, d)
    bt = torch.stack([torch.randperm(n_pages, generator=gen, device="cuda")[:max_pages]
                      for _ in range(b)]).int()
    if phase == "decode":
        lens = torch.randint(200, 1533, (b,), generator=gen, device="cuda").int()
        lens[-1] = 0  # an inactive slot: trash page, O = 0, LSE = -inf
        bt[-1] = n_pages
    else:
        lens = torch.tensor([1024], dtype=torch.int32, device="cuda")  # 4th chunk
    q = torch.randn((b, sq, h, d), generator=gen, device="cuda").bfloat16()
    sc = {} if ks is None else dict(k_scales=ks, v_scales=vs)
    sc1 = {} if ks is None else dict(k_scales=ks[1], v_scales=vs[1])

    def kernel():
        return paged_attention(q, kp, vp, bt, lens, layer_idx=1, **sc)

    splits = resolve_num_splits(0, b, h_k, sq * (h // h_k), max_pages)

    def plain():
        return paged_attention_ref(q, kp[1], vp[1], bt, lens, num_splits=splits, **sc1)

    o, lse = kernel()
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
          and lse_plain_err <= ltol and lerr <= ltol)
    name = f"paged_attention.{phase}[{str(kv_dtype).split('.')[-1]}]"
    checks.add(name, ok, max_abs_err=plain_err, tolerance=tol, err_vs_f32_oracle=err,
               lse_err=lse_plain_err, lse_err_vs_f32_oracle=lerr, lse_tolerance=ltol,
               dead_rows_ok=dead_ok, num_splits=splits)

    # bound: q, the live K/V rows (and scales) and the block tables read once,
    # O and LSE written once; 4 * d operations per (query head, visible key)
    lens_l = [int(x) for x in lens.tolist()]
    visible = sum(sum(max(0, min(n, n - sq + t + 1)) for t in range(sq)) for n in lens_l)
    kv_row = 2 * d * kp.element_size() + (8 if ks is not None else 0)  # K, V, scales
    by = nbytes(q, bt, lens, o, lse) + sum(lens_l) * h_k * kv_row
    ops = 4 * d * h * visible
    # library yardstick: SDPA over the gathered, dequantized, head-expanded KV
    T = max_pages * page
    kg = kp[1][bt.long()].transpose(1, 2).reshape(b, h_k, T, d).float()
    vg = vp[1][bt.long()].transpose(1, 2).reshape(b, h_k, T, d).float()
    if ks is not None:
        kg = kg * ks[1][bt.long()].transpose(1, 2).reshape(b, h_k, T, 1)
        vg = vg * vs[1][bt.long()].transpose(1, 2).reshape(b, h_k, T, 1)
    kg = kg.bfloat16().repeat_interleave(h // h_k, dim=1)
    vg = vg.bfloat16().repeat_interleave(h // h_k, dim=1)
    kcol = torch.arange(T, device="cuda")
    qpos = lens.long()[:, None] - sq + torch.arange(sq, device="cuda")[None]  # (b, sq)
    mask = (kcol[None, None] <= qpos[..., None]) & (kcol[None, None] < lens.long()[:, None, None])
    mask = mask[:, None]  # (b, 1, sq, T)
    mask[~live] = True  # SDPA gives NaN on fully masked rows; dead rows are not compared
    qt = q.transpose(1, 2)

    def library():
        return F.scaled_dot_product_attention(qt, kg, vg, attn_mask=mask)

    return dict(
        ms=timer.ms(kernel), plain_ms=timer.ms(plain, PLAIN_REPS),
        library_ms=timer.ms(library), bound=bound(by, ops), err=plain_err, tol=tol,
    )


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
    return dict(ms=timer.ms(kernel), plain_ms=timer.ms(plain, PLAIN_REPS), library_ms=None,
                bound=bound(by, 0), err=0.0 if equal else float("nan"), tol=0.0)


def check_qmm(gen, timer, checks, w_dtype, m, shapes, stacked, timed=True):
    """K3 (stacked, layer_idx) / K4 (one weight) over `shapes` at m rows.
    2x rule against the f32 product, with the plain version (f32 product
    rounded to bf16) as the low-precision oracle. Times (when `timed`) are
    summed over the shapes: one layer's projections, or the lm_head."""
    from xf_flash_attention_cutlass_tpu_torch.quant.linear import (
        quantize_weight,
        quantized_matmul,
        quantized_matmul_ref,
    )

    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0, ops=0)
    worst = (0.0, 1.0)
    for K, N in shapes:
        w = torch.randn((K, N), generator=gen, device="cuda") / math.sqrt(K)
        if w_dtype == torch.bfloat16:
            wq, s = w.bfloat16(), None
        else:
            wq, s = quantize_weight(w, w_dtype)
        del w
        x = torch.randn((m, K), generator=gen, device="cuda").bfloat16()
        if stacked:
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
        route = "qmm.stacked" if stacked else "qmm.single"
        checks.add(f"{route}[m={m},K={K},N={N},{str(w_dtype).split('.')[-1]}]", err <= tol,
                   max_abs_err=err, tolerance=tol)
        if err / tol >= worst[0] / worst[1]:
            worst = (err, tol)
        if not timed:
            continue
        w_deq = (wq.float() * (s if s is not None else 1.0)).bfloat16()
        tot["ms"] += timer.ms(kernel)
        tot["plain_ms"] += timer.ms(plain, PLAIN_REPS)
        tot["library_ms"] += timer.ms(lambda: torch.matmul(x, w_deq))
        tot["bytes"] += nbytes(x, wq, s, y)
        tot["ops"] += 2 * m * K * N
        del w_deq
    if not timed:
        return None
    return dict(ms=tot["ms"], plain_ms=tot["plain_ms"], library_ms=tot["library_ms"],
                bound=bound(tot["bytes"], tot["ops"]), err=worst[0], tol=worst[1])


def check_other_shapes(gen, checks):
    """Shapes off the serving path that the kernels also take, checked but
    not timed: qmm at ragged m, K and N (unaligned rows take the kernel's
    element-wise loads), paged attention at page 16 and head_dim 64 with
    several row tiles, split runs and non-causal rows, and appends of
    several tokens at unaligned positions."""
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
    """bf16 q, k, v, dO (BHSD) and the mask keywords: opts may hold causal,
    window, softcap, kv_lens (a list) and segments (True: two segments per
    row, and one query row whose segment no key has)."""
    q, k, v, do = (torch.randn(s, generator=gen, device="cuda").bfloat16()
                   for s in ((b, h, sq, d), (b, h_k, sk, d), (b, h_k, sk, d), (b, h, sq, d)))
    kw = {n: x for n, x in opts.items() if n not in ("kv_lens", "segments")}
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


def check_flash_fwd(gen, checks, name, b, h, h_k, sq, sk, d, opts):
    """K7 against its plain version and the dense f32 oracle
    (utils/testing.py) under the 2x rule: twice the low-precision oracle's
    error plus 1e-5, for O and for LSE; rows that see no key give O = 0 and
    LSE = -inf. Returns the inputs and the case's error and tolerance."""
    from xf_flash_attention_cutlass_tpu_torch.ops.flash_fwd import flash_fwd, flash_fwd_ref
    from xf_flash_attention_cutlass_tpu_torch.utils.testing import flash_attention_oracle

    (q, k, v, _), kw = flash_case(gen, b, h, h_k, sq, sk, d, opts)
    o, lse = flash_fwd(q, k, v, **kw)
    o_plain, lse_plain = flash_fwd_ref(q, k, v, **kw)
    o32, l32 = flash_attention_oracle(q, k, v, **kw)
    olp, llp = flash_attention_oracle(q, k, v, upcast=False, **kw)
    torch.cuda.synchronize()
    live = torch.isfinite(l32)
    tol, ltol = 2 * max_err(olp, o32) + 1e-5, 2 * max_err(llp[live], l32[live]) + 1e-5
    err, plain_err = max_err(o, o32), max_err(o, o_plain)
    lerr, lplain = max_err(lse[live], l32[live]), max_err(lse[live], lse_plain[live])
    empty_ok = bool((o[~live] == 0).all() and torch.isneginf(lse[~live]).all())
    ok = (bool(torch.isfinite(o).all()) and empty_ok and err <= tol and plain_err <= tol
          and lerr <= ltol and lplain <= ltol)
    checks.add(f"flash_fwd.{name}", ok, max_abs_err=plain_err, tolerance=tol,
               err_vs_f32_oracle=err, lse_err=lplain, lse_err_vs_f32_oracle=lerr,
               lse_tolerance=ltol, empty_rows=int((~live).sum()), empty_rows_ok=empty_ok)
    return (q, k, v), kw, plain_err, tol


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
    return dict(
        ms=timer.ms(lambda: flash_fwd(q, k, v, **kw)),
        plain_ms=timer.ms(lambda: flash_fwd_ref(q, k, v, **kw), PLAIN_REPS),
        library_ms=timer.ms(lambda: F.scaled_dot_product_attention(q, kx, vx, is_causal=True)),
        bound=bound(by, ops), err=err, tol=tol,
    )


def check_flash_bwd(gen, checks, name, b, h, h_k, sq, sk, d, opts):
    """K9 + K10 (two-pass) and K11 (fused) against the plain version and the
    gradients of the dense oracle under the 3x rule: three times the
    low-precision oracle's error plus 1e-4, for dq, dk and dv. The residuals
    O and LSE come from the plain forward. Returns the inputs, the residuals
    and the worst (error, tolerance) of each route."""
    from xf_flash_attention_cutlass_tpu_torch.ops.flash_bwd import flash_bwd, flash_bwd_ref
    from xf_flash_attention_cutlass_tpu_torch.ops.flash_fwd import flash_fwd_ref
    from xf_flash_attention_cutlass_tpu_torch.utils.testing import flash_attention_oracle

    (q, k, v, do), kw = flash_case(gen, b, h, h_k, sq, sk, d, opts)
    o, lse = flash_fwd_ref(q, k, v, **kw)

    def oracle_grads(upcast):
        xs = [(t.float() if upcast else t).detach().requires_grad_(True) for t in (q, k, v)]
        out, _ = flash_attention_oracle(*xs, upcast=upcast, **kw)
        return torch.autograd.grad((out.float() * do.float()).sum(), xs)

    g32, glp = oracle_grads(True), oracle_grads(False)
    plain = flash_bwd_ref(q, k, v, o, lse, do, **kw)
    worst = {}
    for route, fused in (("two_pass", None), ("fused", True)):
        got = flash_bwd(q, k, v, o, lse, do, fused=fused, **kw)
        torch.cuda.synchronize()
        res = {}
        for gname, x, x32, xlp, xp in zip(("dq", "dk", "dv"), got, g32, glp, plain):
            tol = 3 * max_err(xlp, x32) + 1e-4
            res[gname] = (max_err(x, xp), max_err(x, x32), tol)
        ok = all(bool(torch.isfinite(x).all()) for x in got) and all(
            pe <= tol and e <= tol for pe, e, tol in res.values())
        checks.add(f"flash_bwd.{route}.{name}", ok,
                   **{f"{g}_err": r[0] for g, r in res.items()},
                   **{f"{g}_err_vs_f32_oracle": r[1] for g, r in res.items()},
                   **{f"{g}_tolerance": r[2] for g, r in res.items()})
        worst[route] = max(((r[0], r[2]) for r in res.values()), key=lambda t: t[0] / t[1])
    return (q, k, v, o, lse, do), kw, worst


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
    run = FlashBwdLaunch(q, k, v, o, lse, do, scale=1.0 / math.sqrt(d),
                         causal=kw.get("causal", False), window=kw.get("window", (-1, -1)),
                         softcap=kw.get("softcap", 0.0), kv_lens=kw.get("kv_lens"),
                         q_segment_ids=kw.get("q_segment_ids"),
                         kv_segment_ids=kw.get("kv_segment_ids"))
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
            ("flash_bwd.dq", run.dq, 3, (dq,), "two_pass"),
            ("flash_bwd.dkv", run.dkv, 4, (dk, dv), "two_pass"),
            ("flash_bwd.fused", run.fused, 5, (dq, dk, dv), "fused")):
        out[key] = dict(ms=timer.ms(fn), plain_ms=plain_ms, library_ms=library_ms,
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


def check_flash(gen, timer, checks, cfg):
    """K7 at the bucketed-prefill shapes (Llama-8B heads, one prompt whose
    kv_len is 70 % of its bucket; bucket 1024 timed, 256, 512 and 2048 not)
    and at the training shape (s = 1024, causal, no kv_lens), K9, K10 and
    K11 at the training shape, and the shapes off those paths, untimed. Returns the timed results by launch-counter name."""
    h, h_k, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    measured = {}
    for bucket in (256, 512, 1024, 2048):
        kv_len = int(0.7 * bucket)
        x, kw, err, tol = check_flash_fwd(gen, checks, f"bucket{bucket}_kv{kv_len}", 1, h, h_k,
                                          bucket, bucket, d, dict(causal=True, kv_lens=[kv_len]))
        if bucket == 1024:
            measured["flash_fwd"] = time_flash_fwd(timer, *x, kw, err, tol)
        del x
    check_flash_fwd(gen, checks, "train_s1024", 1, h, h_k, 1024, 1024, d, dict(causal=True))
    tensors, kw, worst = check_flash_bwd(gen, checks, "train_s1024", 1, h, h_k, 1024, 1024, d,
                                         dict(causal=True))
    measured.update(time_flash_bwd(timer, tensors, kw, worst))
    del tensors
    for name, *shape, opts in FLASH_OFF_PATH:
        check_flash_fwd(gen, checks, f"other.{name}", *shape, opts)
        check_flash_bwd(gen, checks, f"other.{name}", *shape, opts)
    return measured


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


def profiled(fn, n_steps=1):
    """Run fn n_steps times under torch.profiler; the kernels' summed device
    time per step and the ten largest, or None where the trace holds no
    device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n_steps):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    total_us = sum(e.self_device_time_total for e in kernels)
    if total_us <= 0:
        return None
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    return dict(
        steps=n_steps, device_ms_per_step=total_us / 1e3 / n_steps,
        host_s=time.perf_counter() - t0,  # the profiled steps, the trace and its parse
        top=[dict(kernel=e.key[:90], ms_per_step=e.self_device_time_total / 1e3 / n_steps,
                  calls_per_step=e.count / n_steps) for e in top],
    )


def profile_decode(eng, cfg, seed, n_steps=3):
    """Device time of decode-only engine steps with 8 active requests, from
    a torch.profiler trace (`profiled`). The engine prefills whole prompts
    (bucketed), so one step admits all 8."""
    rng = np.random.default_rng(seed + 2)
    n = eng.ecfg.max_batch
    for i in range(n):
        eng.add_request(1000 + i, rng.integers(0, cfg.vocab_size, 256).tolist(), n_steps + 2)
    eng.step()  # admit and prefill every request, and the first decode
    if len(eng.active) != n:
        raise RuntimeError(f"decode profile: {len(eng.active)} of {n} requests active")
    prof = profiled(eng.step, n_steps)
    eng.run()
    return prof


# ---- main ---------------------------------------------------------------------

_PKG = "xf_flash_attention_cutlass_tpu_torch/csrc/"
_TPU = "xf_flash_attention_cutlass_tpu/"
KERNELS = {  # launch-counter name: (source, TPU kernel it replaces)
    "paged_attention.decode": (_PKG + "paged_attention.cu", _TPU + "ops/paged.py:97"),
    "paged_attention.prefill": (_PKG + "paged_attention.cu", _TPU + "ops/paged.py:97"),
    "paged_append.decode": (_PKG + "paged_append.cu", _TPU + "ops/paged_append.py:68"),
    "paged_append.prefill": (_PKG + "paged_append.cu", _TPU + "ops/paged_append.py:166"),
    "qmm.stacked.bm16": (_PKG + "qmm.cu", _TPU + "quant/linear.py:70"),
    "qmm.stacked.bm64": (_PKG + "qmm.cu", _TPU + "quant/linear.py:70"),
    "qmm.single.bm16": (_PKG + "qmm.cu", _TPU + "quant/linear.py:48"),
    "flash_fwd": (_PKG + "flash_fwd.cu", _TPU + "ops/flash_fwd.py:100"),
    "flash_bwd.dq": (_PKG + "flash_bwd.cu", _TPU + "ops/flash_bwd.py:228"),
    "flash_bwd.dkv": (_PKG + "flash_bwd.cu", _TPU + "ops/flash_bwd.py:284"),
    "flash_bwd.fused": (_PKG + "flash_bwd.cu", _TPU + "ops/flash_bwd.py:156"),
}
# the kernels each main path must launch (and it may call no plain version)
PATHS = {
    "serve_chunked": ["paged_attention.decode", "paged_attention.prefill",
                      "paged_append.decode", "paged_append.prefill", "qmm.stacked.bm16",
                      "qmm.stacked.bm64", "qmm.single.bm16"],
    "serve_bucketed": ["flash_fwd", "paged_append.prefill", "paged_attention.decode",
                       "paged_append.decode", "qmm.stacked.bm16", "qmm.stacked.bm64",
                       "qmm.single.bm16"],
    "train": ["flash_fwd", "flash_bwd.dq", "flash_bwd.dkv", "flash_bwd.fused"],
}


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
    _build.build_all()
    report["build_s"] = time.perf_counter() - t0
    mark("build")
    print(f"build: {report['build_s']:.1f} s for {len(_build.SOURCES)} kernel sources", flush=True)

    # 2. kernels against their plain versions, at the main paths' shapes
    cfg = LlamaConfig.llama8b()
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    timer = Timer()
    checks = Checks()
    measured = {}
    for kv_dtype in (torch.float8_e4m3fn, torch.int8, torch.bfloat16):
        for phase in ("decode", "prefill"):
            r = check_paged_attention(gen, timer, checks, kv_dtype, phase, cfg)
            if kv_dtype == torch.float8_e4m3fn:
                measured[f"paged_attention.{phase}"] = r
            r = check_paged_append(gen, timer, checks, kv_dtype, phase, cfg)
            if kv_dtype == torch.float8_e4m3fn:
                measured[f"paged_append.{phase}"] = r
    d, hd = cfg.dim, cfg.head_dim
    layer_shapes = [(d, cfg.n_heads * hd), (d, cfg.n_kv_heads * hd), (d, cfg.n_kv_heads * hd),
                    (cfg.n_heads * hd, d), (d, cfg.ffn_dim), (d, cfg.ffn_dim), (cfg.ffn_dim, d)]
    distinct = sorted(set(layer_shapes))
    for w_dtype in (torch.int8, torch.float8_e4m3fn, torch.bfloat16):
        for m in (8, 256):
            if w_dtype == torch.int8:  # timed: one layer's seven projections
                r = check_qmm(gen, timer, checks, w_dtype, m, layer_shapes, True)
                measured[f"qmm.stacked.bm{16 if m <= 16 else 64}"] = r
            else:
                check_qmm(gen, timer, checks, w_dtype, m, distinct, True)
    for m in (512, 1024, 2048):  # bucketed prefill: m = the bucket, untimed
        check_qmm(gen, timer, checks, torch.int8, m, layer_shapes, True, timed=False)
    for m in (1, 8, 256):  # the int8 lm_head: m=1 after a chunk, 8 per decode step
        r = check_qmm(gen, timer, checks, torch.int8, m, [(d, cfg.vocab_size)], False)
        if m == 8:
            measured["qmm.single.bm16"] = r
    check_other_shapes(gen, checks)
    check_bucket_append(gen, checks, cfg)
    report["page32_append"] = check_page32_append(gen, timer, checks, cfg)
    measured.update(check_flash(gen, timer, checks, cfg))
    report["sdpa_fwd_bwd_ms"] = measured["flash_bwd.fused"]["library_fwd_bwd_ms"]
    checks.raise_on_failure("kernel comparison")
    del timer
    torch.cuda.empty_cache()
    mark("kernels")
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
    prof = profile_decode(eng, cfg, args.seed)
    if prof is not None:  # device busy share of a decode-only step
        prof["busy_share_of_p50_step"] = (prof["device_ms_per_step"]
                                          / bucketed["decode_step_ms"]["p50"])
    report["decode_profile"] = prof
    print(json.dumps({"decode_profile": prof}), flush=True)
    del eng
    mark("decode_profile")

    # 5. the kernels line, the card, the result
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
