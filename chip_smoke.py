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
   ones. Every decode step is the replay of a CUDA graph: after each
   serving run, each captured graph is replayed on its static buffers and
   held bit for bit against the eager step on the same buffers
   (`check_graph_replay`); the decode profile also traces the eager step on
   those buffers and times both on the host clock. Between the two runs,
   the engine's features (`serve_features`): the 8 chunked requests again
   in windows of 4 decode steps (streams equal to the per-step run's), a
   sampled run (top-k 50, top-p 0.9, temperature 0.8) in windows and again
   per step (equal, every token in the vocabulary) with each sampling
   route's device time (`sampling_times`), speculate_k = 3 on prompts of
   repeated phrases and a 512-token registered prefix, each against the
   per-step run under the tie rule (`TIE_DELTA`).
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
   kernel of the path ran and no plain version did; the serving features'
   runs (windows, sampled, speculative, prefix) are main paths too.
6. Serve the MoE family (`serve_moe`): Mixtral-8x7B geometry (32 layers,
   full width, 8 experts, top-2, capacity factor 1.25) with INT8 weights
   drawn and quantized a layer at a time, over an FP8 page-256 KV cache.
   First the reference check of the cores (2 layers) against the CPU, with
   the routing (the same two experts wherever the f32 router's second
   choice leads its third by more than ROUTER_MARGIN and twice the bf16 CPU
   run's error on that row, in the first layer), and K3 on the expert
   stack's (L * E, d_in, d_out) view at entries 0 and 255 (past 2**31
   bytes) at m = 8 and 80; then the 8 serving requests (32 new tokens),
   chunked and bucketed, each a main path (K3's decode and wgmma routes at
   l * E + e, K1, the append kernel, K4, and K7 when bucketed; no WMMA
   kernel), their graphs held to the eager step and the tie rule between
   the two runs' streams measured, not held (top-k routing flips where a
   router is near a tie, and the logits downstream move by O(1)); a chunked
   engine saved once its prefills
   are done and 4 decode steps later, resumed in a fresh engine (streams
   equal to the uninterrupted run's) and loaded again (pools byte-equal),
   with the file's size and the save and load seconds; one decode step
   profiled (`moe_decode_profile`: device time, K3 by route, the cuBLAS
   GEMMs of the dispatch and combine, busy share, tokens/s, the split
   counters zero after); and two SGD steps of the MoE loss at 2 layers, bf16,
   512 tokens (K7, K9, K10), the losses falling, after which those bf16
   params (plain experts) serve 8 short requests through a bucketed engine
   (its graph against the eager step).
7. fp16 and f32 (`check_dtype_kernels`, `check_refusals`,
   `api_dtype_path`, `serving_dtype_paths`): the fp16 and f32
   instantiations of K1 (decode and chunk at the engine's shapes over fp16,
   fp8 and int8 pools for fp16 queries, f32, fp8 and int8 for f32 ones, the
   options on every route, an odd page on the WMMA kernel, the combine
   kernel writing fp16 and f32), of the append kernel (fp16 and f32 rows
   into pools of their dtype, int8 and fp8, decode, chunk and page 32, bit
   for bit) and of K3/K4 (fp16 activations on the decode, wgmma and WMMA
   kernels over int8, fp8 and fp16 weights; f32 activations on the f32
   kernel over f32, int8 and fp8 weights), each against its plain version
   under the 2x rule (float64 oracles for f32), the serving shapes timed
   beside their bound (f32 operations at F32_FLOPS) and SDPA / cuBLAS in the
   working dtype (flash_attention in fp16 beside the fp16 options rows); f64
   refused by every kernel's wrapper, K1 to K11, and mixed dtypes by K7
   (TypeError naming the kernel); the api's KV-cache decode and paged
   varlen over fp16 and f32 caches against the plain versions (`api_dtypes`,
   a main path). Then Llama-8B at full width and depth served twice, each a
   main path after the reference check of its cores (2 layers) against the
   CPU in its dtype and in f32 (f64 for f32): `serve_fp16` (fp16
   activations, INT8 weights, FP8 page-256 cache, bucketed prefill through
   K7 in fp16) and `serve_f32` (unquantized f32 weights, 32.1 GB; an f32
   cache of 48 pages of 256; 256-token chunked prefill), their graphs held
   to the eager step and a decode step profiled.
8. The dense flash family in f32 (`f32_flash_phase`, `serve_f32_bucketed`):
   K7, K8, K9, K10 and K11's f32 kernels (csrc/flash_f32.cu) against their
   plain versions in f64 (the oracle) and f32 (the low-precision oracle)
   under the 2x rule: K7 at bucket 1024, `train_s1024` and s = 2048, K9-K11
   at `train_s1024` (both routes, bit-reproducible K9 and K10, K11's dK/dV
   equal to K10's), K8 at the api shape with ALiBi and dropout (its dropout
   signs equal to the bf16 kernel's), timed beside their bound at
   F32_FLOPS and SDPA in f32 (the backend named); untimed at GQA, d = 64,
   unaligned lengths, every option and the packed prompts; then three main
   paths: `train_f32` (Llama-8B widths cut to 8 layers, f32, three SGD
   steps on K7/K9/K10 and one on K11, the loss falling; a 2-layer copy's
   gradient against the plain versions in f64 on the card), `api_f32`
   (flash_attn_func in f32 at 2048 tokens with ALiBi, dropout, the plane
   and the gradient; packed varlen with its gradient; one call at d = 64;
   checked after against the plain versions) and, beside `serve_f32` on
   its params, `serve_f32_bucketed` (bucketed prefill: K7 in f32; its
   streams equal to the chunked run's, or held to the tie rule).
9. Every head dim in K1 and K7 (`head_dims_phase`, `serve_phi3`): the
   decode and f32 kernels' resident blocks at every rung (64, 128, 192,
   256) against the split plan's tables; K1 and K7 at d = 16, 32, 40, 59,
   64, 80, 96, 111, 128, 160, 192, 224 and 256 under the 2x rule against
   their plain versions and the oracles (K1: decode and 256-row chunks,
   bf16 and fp16 queries over pools of their own dtype, fp8 and int8, f32;
   odd pages on the WMMA kernel; the combine on every split run; K7 and its
   f32 kernel, causal and not), each launch asserted at the head dim and
   rung the route functions name (the padded copy at 59, 111 and 40 over
   byte pools); the options at d = 96 and 256 on K1's Hopper kernels and
   K7; rows timed at d = 96 and 256 (K1 decode, chunk, combine and f32
   decode, K7 at bucket 1024 and its f32 kernel, Phi-3 geometry). Then
   Phi-3-mini-4k widths (head dim 96, 32 layers, random INT8 weights, FP8
   KV at page 256): the reference check of its cores, the 8 serving
   requests as two main paths, `serve_phi3_chunked` (256-token chunks) and
   `serve_phi3_bucketed` (K7 at d = 96), every K1 and K7 launch at d = 96
   on the rung 128, graphs held to the eager step, the streams to each
   other (equal, or the tie rule), a profiled decode step.
10. Every head dim in K8 and K9-K11 (`check_bwd_head_dims`,
   `bwd_head_dim_rows`, `train_phi3`, `api_phi3`): K8, K9, K10 and K11 at
   d = 16, 32, 40, 59, 80, 96, 111, 160, 192, 224 and 256 (bf16 and fp16
   on the Hopper kernels, causal and not, GQA 4:1 at 96 and 256; f32 on
   the f32 kernels) under the 3x rule (K9-K11, the f32 ones the 2x rule
   against the f64 plain versions) and entry by entry (K8), each launch at
   the head dim and rung the route functions name (the padded copy at 59
   and 111 only); at 96 and 256 K9 and K10 bit-reproducible, K11's dK/dV
   equal to K10's, and the options (ALiBi with dropout and K8's signs,
   window with softcap, segments with kv_lens, explicit positions with
   per-row ALiBi); rows timed at d = 96 and 256 (K9, K10, K11 and their f32
   kernels at train_s1024's shape with 32/32 heads, SDPA's backward beside
   them; K8 and K8 f32 at the api shape). Then two main paths at Phi-3-mini
   widths: `train_phi3` (32 layers, bf16, three two-pass SGD steps and one
   fused, the loss falling, every K7-K11 launch at d = 96 on the rung 128;
   a 2-layer copy's gradient against the plain versions on the card) and
   `api_phi3` (flash_attn_func at 32 heads, d = 96, 2048 tokens, causal,
   ALiBi, dropout, the plane and the gradient; packed varlen's gradient;
   checked after against the plain versions).
11. The parallel layers (`serve_mesh`, run beside phase 4's chunked
   engine and its params): Llama-8B served as in phase 4 on a tp = 1 mesh
   over a one-rank NCCL group (`serve_mesh_tp1`: its streams equal to the
   single-device engine's token for token, its graphs to their eager runs,
   each decode graph holding the reduce-scatter + all-gather structure's
   130 collectives; both engines' decode graphs replayed under a profiler
   trace, in turns); `tp_loss_and_grad` on that mesh at Llama-8B widths
   cut to 2 layers against the single-device loss and gradient under the
   3x rule (`train_mesh_tp1`); K1, K3 and K4 at the tp = 2 and 4 shard
   shapes against their plain versions, with their routes; and, when the
   card's compute mode allows it, dp = 2 x tp = 1 in two processes sharing
   the card (`serve_mesh_dp2`: 4 layers, a one-rank NCCL tp group each, the
   replicas' exchange over gloo), held to a single-device engine's streams
   by the tie rule. Otherwise it prints why it skipped that step. The
   tp = 1 mesh engine is also saved mid-stream (`save_engine` on a mesh:
   each pool's blocks sent to rank 0's host one leaf at a time, rank 0
   writing, no device memory added), loaded onto the mesh and run on: its
   streams equal the uninterrupted run's.
12. Expert parallelism (`serve_mesh_ep`, run inside phase 6 beside its
   Mixtral-geometry INT8 params, which the mesh engine shares: one rank's
   shard of each expert stack is the stack itself): the 8 serving requests
   on an ep = 1 mesh over a one-rank NCCL group, through the ep prefill
   chunks and decode steps (the dispatched blocks exchanged by an
   all-to-all each way a layer, the identity at one rank), a main path;
   its streams equal to phase 6's chunked engine's token for token, its
   decode graph equal to the eager step and to `ep_decode_step` run
   eagerly on the same buffers, the collectives in the graph counted (2
   all-to-alls a layer), and its replay profiled beside the bucketed
   single-device engine's, in turns; then, once phase 6's INT8 params are
   freed, `moe_ep_loss_and_grad` at Mixtral widths cut to 2 layers against
   moe_loss_fn's gradients under the 3x rule (`train_mesh_ep`, a main
   path); and a probe of two processes exchanging CUDA tensors over NCCL
   on the one card (`nccl_two_process_probe`), which says whether an
   ep = 2 mesh can run on it.
13. Pipeline parallelism (`serve_pp`, run inside phase 11's one-rank NCCL
   group, beside phase 4's INT8 params, which it shares): on a pp = 1 mesh,
   8 requests' state after a single-device chunked prefill, then 16 greedy
   `pp_decode_step` calls at n_micro = 4 (`serve_pp1`, a main path: every
   microbatch through K2, K1 and its combine, K3 and K4, one stage shift a
   schedule step, a send to self at one rank); its tokens, logits and every
   pool page equal to 16 `decode_core` runs on each microbatch's rows bit for
   bit, its streams held to the whole-batch step by the tie rule; one step
   of each profiled in turns (whole, pp, pp, whole). Then
   `pp_loss_and_grad` at Llama-8B widths cut to 2 layers, tokens (2, 1025),
   n_micro = 2, under the 3x rule (`train_pp1`, a main path). No pp > 1
   runs on one card.
14. Sequence parallelism (`serve_cp`, run inside phase 11's one-rank NCCL
   group after phase 13), at Llama-8B attention width (32 q / 8 kv heads,
   d = 128, bf16, b = 1), forward and backward. At cp = 1, 8192 tokens
   through `ring_attention` (causal and not), `ring_attention_zigzag` and
   `ulysses_attention` (main paths `train_cp1_ring`, `_zigzag`,
   `_ulysses`): the ring and Ulysses equal to `flash_attention` with the
   hop's masks bit for bit, the zigzag ring under the 2x / 3x rule against
   an f32 oracle computed head by head, the collectives counted (the
   ring's backward 4 a hop and 2 to deliver), and a CUDA tensor on a gloo
   group refused. Then the cp = 4 schedule in one process, 16384 tokens
   (`train_cp4_schedule`, a main path): every rank's hops of the ring and
   the zigzag ring through `parallel/ring.py`'s schedules in lockstep, and
   each rank's Ulysses head slice (8 q / 2 kv heads over the whole
   sequence), under the 2x / 3x rule with the dense K7/K9/K10 over the
   whole sequence as the low-precision run; each hop kind's times, each
   rank's device time and the dense kernels' times beside them. No cp > 1
   runs across processes on one card.
15. Print the seconds of each phase, the `kernels` JSON line (with the rows
   at d = 96 and 256, "<label>@d<d>"), the card's name and power limit,
   and, last, {"ok": true, "device": {...}}.

Needs a CUDA device; exits with an error and prints no result without one.
With --out DIR, the details of every phase also go to DIR/chip_smoke.json.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import math
import os
import pickle
import re
import shutil
import subprocess
import sys
import tempfile
import time
from collections import Counter

import numpy as np
import torch
import torch.nn.functional as F

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12  # dense bf16 tensor-core peak, H100 SXM (fp16 the same)
F32_FLOPS = 67e12  # f32 FMA peak (no tensor cores), H100 SXM: the f32 kernels' rate
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


DEVICE_TRACES = []  # each device_ms trace: the kernel, the launches made and those recorded


def device_ms(fn, kernel, reps=REPS):
    """Device time of one launch of the kernel whose name holds `kernel`
    (fn launches it once a call), from a profiler trace of `reps` calls,
    each behind a read-only pass over a 128 MB buffer (the L2 starts cold
    and clean): the kernel alone, without the launch and event costs that
    the Timer includes. The mean is over the launches the trace recorded,
    which may be fewer than those made (DEVICE_TRACES keeps both counts).
    None when the trace holds no such kernel."""
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
    found = [e for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA and kernel in e.key]
    us, n = sum(e.self_device_time_total for e in found), sum(e.count for e in found)
    DEVICE_TRACES.append(dict(kernel=kernel, launched=reps, recorded=n))
    return us / 1e3 / n if us > 0 else None


def bound(n_bytes: float, n_ops: float, peak: float = BF16_FLOPS) -> tuple:
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and
    operations over `peak` (the bf16 tensor-core peak; F32_FLOPS for the
    f32 kernels)."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / peak
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


QUANT = (torch.int8, torch.float8_e4m3fn)
DT_TAG = {torch.bfloat16: "bf16", torch.float16: "f16", torch.float32: "f32",
          torch.int8: "int8", torch.float8_e4m3fn: "float8_e4m3fn"}


def peak_of(dtype) -> float:
    """The operations rate a kernel's bound takes for activations of dtype."""
    return F32_FLOPS if dtype == torch.float32 else BF16_FLOPS


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
        if kv_dtype not in QUANT:
            out.append((x.to(kv_dtype), None))
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
    (in q's dtype), with the bottom-right causal mask and kv_len; rows that
    see no key are unmasked (SDPA gives NaN on them; they are not compared)."""
    b, sq, h, d = q.shape
    h_k, page = kp.shape[1], kp.shape[2]
    pages = (T + page - 1) // page
    idx = bt[:, :pages].long()

    def dense(pool, scales):
        x = pool[idx].transpose(1, 2).reshape(b, h_k, pages * page, d)[:, :, :T].float()
        if scales is not None:
            x = x * scales[idx].transpose(1, 2).reshape(b, h_k, pages * page, 1)[:, :, :T]
        return x.to(q.dtype).repeat_interleave(h // h_k, dim=1)

    kg, vg = dense(kp, ks), dense(vp, vs)
    kcol = torch.arange(T, device=q.device)
    qpos = lens.long()[:, None] - sq + torch.arange(sq, device=q.device)[None]  # (b, sq)
    mask = (kcol[None, None] <= qpos[..., None]) & (kcol[None, None] < lens.long()[:, None, None])
    mask = mask[:, None]  # (b, 1, sq, T)
    mask[lens == 0] = True
    qt = q.transpose(1, 2)
    return lambda: F.scaled_dot_product_attention(qt, kg, vg, attn_mask=mask)


def paged_inputs(gen, kv_dtype, phase, cfg, kv_range=(200, 1533), q_dtype=torch.bfloat16):
    """K1's inputs at the engine's shapes: two layers of page-256 pools of
    64 pages (+ a trash page), 16-page block tables, q (b, sq, h, d) bf16.
    Decode: b = 8, sq = 1, kv_lens drawn from kv_range, the last slot
    inactive (kv_len 0 on the trash page); prefill: one 256-token chunk at
    kv_len 1024. q in q_dtype. Returns (q, k_pool, v_pool, k_scales,
    v_scales, bt, lens)."""
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
    q = torch.randn((b, sq, h, d), generator=gen, device="cuda").to(q_dtype)
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
    out_bytes = q.numel() * q.element_size() + b * h * sq * 4
    by = nbytes(q, bt, lens) + out_bytes + read * kp.shape[-3] * kv_row
    return bound(by, 4 * d * h * visible, peak_of(q.dtype))


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
    route_now, splits = paged.paged_plan(q.shape, kp.shape, kp.dtype, bt.shape[1], **opts,
                                         q_dtype=q.dtype)
    if route != route_now:
        rows = sq * (h // h_k)
        splits = paged.resolve_num_splits(0, b, h_k, rows, bt.shape[1],
                                          paged.route_row_tile(route, rows))
    kw = dict(causal=True, window=(-1, -1), softcap=0.0, alibi_slopes=None, cache_leftpad=None)
    kw.update(opts)
    return splits, lambda: paged._paged_attention_cuda(
        q, kp, vp, layer_idx, bt, lens, 1.0 / math.sqrt(d), kw["causal"], kw["window"],
        kw["softcap"], kw["alibi_slopes"], kw["cache_leftpad"], splits, ks, vs, route)


def check_paged_attention(gen, timer, checks, kv_dtype, phase, cfg, q_dtype=torch.bfloat16,
                          timed=True):
    """K1 at the engine's shapes: decode b=8, sq=1 over kv_lens of the
    serving prompts (the decode kernel), or one 256-token chunk at b=1 (the
    Hopper kernel; also timed through the WMMA kernel on the same inputs),
    with q_dtype queries (f32: the f32 kernel). The tolerance is the 2x
    rule's: twice the error of the dense oracle in the working dtype against
    the dense float32 oracle (utils/testing.py; float64 for f32 queries),
    plus 1e-5. Both the kernel's distance from its plain version and its
    error against the high-precision oracle must stay within it, and the
    call must launch the route paged_plan names. Returns its row (None when
    not `timed`)."""
    from xf_flash_attention_cutlass_tpu_torch import _build
    from xf_flash_attention_cutlass_tpu_torch.ops.paged import (
        paged_attention,
        paged_attention_ref,
        paged_plan,
        route_label,
    )
    from xf_flash_attention_cutlass_tpu_torch.utils.testing import paged_attention_oracle

    h, h_k, d, page, max_pages = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, 256, 16
    q, kp, vp, ks, vs, bt, lens = paged_inputs(gen, kv_dtype, phase, cfg, q_dtype=q_dtype)
    b, sq = q.shape[:2]
    sc = {} if ks is None else dict(k_scales=ks, v_scales=vs)
    sc1 = {} if ks is None else dict(k_scales=ks[1], v_scales=vs[1])

    def kernel():
        return paged_attention(q, kp, vp, bt, lens, layer_idx=1, **sc)

    route, splits = paged_plan(q.shape, kp.shape, kp.dtype, max_pages, q_dtype=q_dtype)
    label = route_label(route, sq * (h // h_k), q_dtype=q_dtype)
    ref_dt = torch.float64 if q_dtype == torch.float32 else torch.float32

    def plain():
        return paged_attention_ref(q, kp[1], vp[1], bt, lens, num_splits=splits, **sc1)

    n0 = _build.LAUNCHES[label]
    o, lse = kernel()
    launched = _build.LAUNCHES[label] - n0 == 1
    o_plain, lse_plain = plain()
    o32, l32 = paged_attention_oracle(q, kp[1], vp[1], bt, lens, ref_dtype=ref_dt, **sc1)
    olp, llp = paged_attention_oracle(q, kp[1], vp[1], bt, lens, upcast=False, ref_dtype=ref_dt,
                                      **sc1)
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
    if q_dtype != torch.bfloat16:
        name = f"paged_attention.{phase}[{DT_TAG[q_dtype]}/{DT_TAG[kv_dtype]}]"
    checks.add(name, ok, max_abs_err=plain_err, tolerance=tol, err_vs_f32_oracle=err,
               lse_err=lse_plain_err, lse_err_vs_f32_oracle=lerr, lse_tolerance=ltol,
               dead_rows_ok=dead_ok, num_splits=splits, route=route, launched=launched)
    if not timed:
        return None

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
    others = () if route == "f32" else ("wmma",) + (("wgmma",) if route == "decode" else ())
    for other in others:
        out[f"{other}_ms"] = timer.ms(forced_route(other, q, kp, vp, ks, vs, bt, lens)[1])
    return out


def check_paged_append(gen, timer, checks, kv_dtype, phase, cfg, row_dtype=torch.bfloat16,
                       timed=True):
    """K2 (decode: 8 rows at scattered positions) and K5 (a 256-token chunk)
    of row_dtype rows: the kernel's pools and scales must equal the plain
    version's bit for bit on every page but the trash page. Returns its row
    (None when not `timed`)."""
    from xf_flash_attention_cutlass_tpu_torch.ops.paged_append import (
        paged_append,
        paged_append_ref,
    )

    h_k, d, page, max_pages, n_pages = cfg.n_kv_heads, cfg.head_dim, 256, 16, 64
    b, sq = (8, 1) if phase == "decode" else (1, 256)
    quant = kv_dtype in QUANT
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
    kn = (torch.randn((b, sq, h_k, d), generator=gen, device="cuda") * 3).to(row_dtype)
    vn = torch.randn((b, sq, h_k, d), generator=gen, device="cuda").to(row_dtype)
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
    if row_dtype != torch.bfloat16:
        name = f"paged_append.{phase}[{DT_TAG[row_dtype]}->{DT_TAG[kv_dtype]}]"
    checks.add(name, equal, max_abs_err=0.0 if equal else float("nan"), tolerance=0.0,
               criterion="bit-equal pools and scales off the trash page")
    if not timed:
        return None
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
              splits=None, x_dtype=torch.bfloat16):
    """K3 (stacked, layer_idx) / K4 (one weight) over `shapes` at m rows of
    x_dtype activations (w_dtype bf16 / fp16 / f32: unscaled weights of that
    dtype). 2x rule against the f32 product (f64 for f32 activations), with
    the plain version (the f32 product rounded to x's dtype) as the
    low-precision oracle. Times (when `timed`) are
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
        if w_dtype not in QUANT:
            wq, s = w.to(w_dtype), None
        else:
            wq, s = quantize_weight(w, w_dtype)
        del w
        x = torch.randn((m, K), generator=gen, device="cuda").to(x_dtype)
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
        acc = torch.float64 if x_dtype == torch.float32 else torch.float32
        y32 = x.to(acc) @ wq.to(acc)
        if s is not None:
            y32 = y32 * s.to(acc)
        err, lp = max_err(y, y32), max_err(plain(), y32)
        tol = 2 * lp + 1e-5
        route = ("qmm.stacked" if stacked else "qmm.single") + (f".{kind}" if kind else "")
        tag = f",splits={splits}" if splits is not None else ""
        xtag = "" if x_dtype == torch.bfloat16 else f"{DT_TAG[x_dtype]}/"
        checks.add(f"{route}[m={m},K={K},N={N},{xtag}{str(w_dtype).split('.')[-1]}{tag}]",
                   err <= tol and y.dtype == x_dtype, max_abs_err=err, tolerance=tol)
        if err / tol >= worst[0] / worst[1]:
            worst = (err, tol)
        if not timed:
            continue
        w_deq = (wq.float() * (s if s is not None else 1.0)).to(x_dtype)
        one = dict(K=K, N=N, ms=timer.ms(kernel), library_ms=timer.ms(lambda: torch.matmul(x, w_deq)),
                   bound_ms=bound(nbytes(x, wq, s, y), 2 * m * K * N, peak_of(x_dtype))[0])
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
                bound=bound(tot["bytes"], tot["ops"], peak_of(x_dtype)), err=worst[0],
                tol=worst[1], per_shape=per_shape)


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


def check_paged_combine(gen, timer, checks, cfg, n_splits, out_dtype=torch.bfloat16, tag=""):
    """The combine kernel against its plain version (combine_partials, then
    O in bf16 and LSE moved to (b, h, sq)) on f32 partials of K1 decode's
    caller layout at the engine's shape (b = 8, sq = 1, 32 heads, cfg's head
    dim: 128 for Llama-8B) and split count, with an empty partial and a row whose partials are all
    empty, O written in out_dtype. Tolerance: O within one rounding to
    out_dtype of the f32 merge (2^-8 |O| for bf16, 2^-11 for fp16, 2^-23 for
    f32, + 1e-6 an element), LSE within 1e-5 + 1e-6 |LSE|; the empty row
    gives O = 0 and LSE = -inf."""
    from xf_flash_attention_cutlass_tpu_torch.ops.combine import combine_partials
    from xf_flash_attention_cutlass_tpu_torch.ops.paged import combine_splits, combine_splits_ref

    b, sq, h, d = 8, 1, cfg.n_heads, cfg.head_dim
    o_part = torch.randn((n_splits, b, sq, h, d), generator=gen, device="cuda")
    lse_part = 4 * torch.randn((n_splits, b, sq, h), generator=gen, device="cuda")
    lse_part[0, 0, 0, 0] = -math.inf  # an empty split
    lse_part[:, -1] = -math.inf  # an inactive slot: every split empty
    rounding = {torch.bfloat16: 2.0 ** -8, torch.float16: 2.0 ** -11,
                torch.float32: 2.0 ** -23}[out_dtype]
    o, lse = combine_splits(o_part, lse_part, out_dtype)
    o_plain, lse_plain = combine_splits_ref(o_part, lse_part, out_dtype)
    o32, _ = combine_partials(o_part, lse_part)
    torch.cuda.synchronize()
    o_excess = float(((o.float() - o32).abs() - rounding * o32.abs()).max())
    finite = torch.isfinite(lse_plain)
    lse_excess = float(((lse[finite] - lse_plain[finite]).abs()
                        - 1e-6 * lse_plain[finite].abs()).max())
    empty_ok = bool((o[-1] == 0).all()) and bool(torch.isneginf(lse[-1]).all())
    same_empty = torch.equal(torch.isfinite(lse), finite)
    ok = o_excess <= 1e-6 and lse_excess <= 1e-5 and empty_ok and same_empty
    err = max_err(o, o_plain)
    tag += "" if out_dtype == torch.bfloat16 else f"{DT_TAG[out_dtype]},"
    checks.add(f"paged_attention.combine[{tag}splits={n_splits}]", ok, max_abs_err=err,
               o_excess_over_one_rounding=o_excess, lse_excess=lse_excess,
               empty_rows_ok=empty_ok)
    # bound: the partials read once, O and LSE written once
    by = nbytes(o_part, lse_part) + b * sq * h * (d * out_dtype.itemsize + 4)
    return dict(ms=timer.ms(lambda: combine_splits(o_part, lse_part, out_dtype)),
                plain_ms=timer.ms(lambda: combine_splits_ref(o_part, lse_part, out_dtype),
                                  PLAIN_REPS),
                library_ms=None, bound=bound(by, 0), err=err,
                tol=float(2 * rounding * o32.abs().max()), splits=n_splits)


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


def check_page32_append(gen, timer, checks, cfg, row_dtype=torch.bfloat16):
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
        kn = (torch.randn((b, sq, h_k, d), generator=gen, device="cuda") * 3).to(row_dtype)
        vn = torch.randn((b, sq, h_k, d), generator=gen, device="cuda").to(row_dtype)

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
        tag = "" if row_dtype == torch.bfloat16 else f"{DT_TAG[row_dtype]}->"
        checks.add(f"paged_append.page32[{tag}{str(kv_dtype).split('.')[-1]},sq={sq}]", equal,
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


def kernel_names(fn, traces=3):
    """The CUDA kernels one call of fn launches, in order (profiler trace).
    fn runs twice in the trace, a spin of the card between, and the kernels
    after the spin are returned: a trace has been seen to miss a kernel of
    the first call after the profiler starts. The calls start
    TRACE_SETTLE_S after the trace does: without it a trace once lost the
    first call and the spin both. A trace that still holds no spin (seen
    on the card for code whose earlier traces held it) is taken again, up
    to `traces` times, before this raises."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(traces):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(TRACE_SETTLE_S)
            fn()
            torch.cuda._sleep(1000)
            fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        names = [e.name[:120] for e in sorted(events, key=lambda e: e.time_range.start)]
        spins = [i for i, n in enumerate(names) if "spin_kernel" in n]
        if spins:
            return names[spins[-1] + 1:]
    raise RuntimeError("kernel_names: the spin between the two calls is not in the trace")


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


def options_decode_inputs(gen, cfg, dtype=torch.bfloat16):
    """The second kvcache call of the api path: b = 8 decode over a dense
    (8, 4096, 8, 128) cache of `dtype` (bf16 there) viewed as page-256
    pages, kv_lens from 1024-4096, and its options: window (1024, 0),
    softcap 30, ALiBi and leftpads from 0-299. Returns (q, k_pool, v_pool,
    bt, lens, options)."""
    from xf_flash_attention_cutlass_tpu_torch.ops.kvcache import dense_cache_as_paged
    from xf_flash_attention_cutlass_tpu_torch.utils.testing import alibi_slopes_ref

    h, h_k, d, b, sk = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, 8, 4096
    kd, vd = (torch.randn((b, sk, h_k, d), generator=gen, device="cuda").to(dtype)
              for _ in range(2))
    kp, pages = dense_cache_as_paged(kd, 256)
    vp, _ = dense_cache_as_paged(vd, 256)
    del kd, vd
    bt = (torch.arange(b, dtype=torch.int32, device="cuda")[:, None] * pages
          + torch.arange(pages, dtype=torch.int32, device="cuda")[None])
    lens = torch.randint(1024, sk + 1, (b,), generator=gen, device="cuda").int()
    q = torch.randn((b, 1, h, d), generator=gen, device="cuda").to(dtype)
    full = dict(window=(1024, 0), softcap=30.0,
                alibi_slopes=torch.from_numpy(alibi_slopes_ref(h)).cuda(),
                cache_leftpad=torch.randint(0, 300, (b,), generator=gen, device="cuda").int())
    return q, kp, vp, bt, lens, full


def options_chunk_inputs(gen, kv_dtype, cfg, q_dtype=torch.bfloat16):
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
    q = torch.randn((b, 256, h, d), generator=gen, device="cuda").to(q_dtype)
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
    route, splits = paged_plan(q.shape, kp.shape, kp.dtype, bt.shape[1], **opts, q_dtype=q.dtype)
    label = route_label(route, sq * (h // kp.shape[-3]), True, q.dtype)
    ref_dt = torch.float64 if q.dtype == torch.float32 else torch.float32
    sc = {} if ks is None else dict(k_scales=ks, v_scales=vs)
    pick = (lambda x: x) if layer_idx is None else (lambda x: None if x is None else x[layer_idx])
    sc1 = {} if ks is None else dict(k_scales=pick(ks), v_scales=pick(vs))
    n0 = _build.LAUNCHES[label]
    o, lse = paged_attention(q, kp, vp, bt, lens, layer_idx=layer_idx, **sc, **opts)
    launched = _build.LAUNCHES[label] - n0 == 1
    o_plain, _ = paged_attention_ref(q, pick(kp), pick(vp), bt, lens, num_splits=splits, **sc1,
                                     **opts)
    o32, l32 = paged_attention_oracle(q, pick(kp), pick(vp), bt, lens, ref_dtype=ref_dt, **sc1,
                                      **opts)
    olp, _ = paged_attention_oracle(q, pick(kp), pick(vp), bt, lens, upcast=False,
                                    ref_dtype=ref_dt, **sc1, **opts)
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

def train(gen, cfg, seed, steps=3, lr=0.005, dtype=torch.bfloat16):
    """Plain SGD on one batch (b = 1, 1024 tokens made from the seed) with
    parameters in dtype (bf16, or f32) at the widths of cfg: `steps` steps
    through the two-pass backward (K9, K10), one through the one-pass
    backward (K11), and one
    more two-pass step under the profiler. Every loss must be finite and
    below the one before it. The rate is small because the embedding
    (entries of about 0.02) feeds an RMS norm that scales its gradient up
    some 50x: at 1.0 the first step overshot. Returns (ok, a dict of the
    losses, the step times on the host clock around a synchronized step,
    and the profiled step's kernels)."""
    from xf_flash_attention_cutlass_tpu_torch.models.llama import init_params, loss_fn

    t0 = time.perf_counter()
    params = init_params(gen, cfg, dtype=dtype)
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

def reference_check(params, cfg, checks, seed, name="engine_reference", dtype=torch.bfloat16):
    """The prefill and decode cores at the model's width (Llama-8B, or
    Mixtral-8x7B geometry), cut to 2 layers, on the card (kernels) against
    the same cores on the CPU (plain versions), for one 128-token chunk, one
    decode step and one bucketed prefill (the same 100-token prompt in its
    128-token bucket). The params are in `dtype`
    (bf16, fp16 or f32), and so is the KV cache where the model is f32 (FP8
    else). 2x rule on the logits: the card's error against the CPU run in
    f32 (f64 for an f32 model) is at most twice the CPU run's error in
    `dtype`, plus 1e-5. For
    an MoE model also the first layer's routing: on every row where the f32
    run's router puts the second expert above the third by more than
    ROUTER_MARGIN and more than twice the bf16 CPU run's probability error
    on that row, the card's run picks the same two experts. Returns the
    seconds of each run."""
    from xf_flash_attention_cutlass_tpu_torch.models import moe
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

    def to(tree, dev, dt=None):  # the model's `dtype` tensors in dt
        if isinstance(tree, dict):
            return {k: to(v, dev, dt) for k, v in tree.items()}
        if isinstance(tree, tuple):
            return tuple(to(v, dev, dt) for v in tree)
        if tree is None:
            return None
        t = tree.to(dev)
        if dt is not None and t.dtype == dtype:
            t = t.to(dt)
        return t

    rng = np.random.default_rng(seed + 1)
    prompt = rng.integers(0, cfg.vocab_size, n_valid)
    next_token = int(rng.integers(0, cfg.vocab_size))
    runs, seconds, routed = {}, {}, {}
    dispatch = moe.top_k_dispatch
    lp_run, ref_run = f"cpu_{DT_TAG[dtype]}", "cpu_f64" if dtype == torch.float32 else "cpu_f32"
    ref_dt = torch.float64 if dtype == torch.float32 else torch.float32
    for run, dev, dt in (("card", "cuda", None), (lp_run, "cpu", None),
                         (ref_run, "cpu", ref_dt)):
        seen = routed[run] = []

        def recording(probs, top_k, capacity, seen=seen):  # the router's probabilities
            seen.append(probs.float().cpu())
            return dispatch(probs, top_k, capacity)

        moe.top_k_dispatch = recording
        t0 = time.perf_counter()
        p = pack_params_for_decode(to(sub, dev, dt))
        shape = (n_layers, n_pages + 1, cfg.n_kv_heads, page, cfg.head_dim)
        if dtype == torch.float32:  # the f32 engine's cache: unquantized, the run's dtype
            kv_dt = dt or dtype
            pools = dict(k=torch.zeros(shape, dtype=kv_dt, device=dev),
                         v=torch.zeros(shape, dtype=kv_dt, device=dev))
        else:
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
        logits_b = prefill_core(p, tokens, n_valid, pools, bt[:, :1], cfg)
        moe.top_k_dispatch = dispatch
        # the decode's inactive row too: it must stay finite (an MoE layer's
        # dispatch would spread a NaN to every row)
        runs[run] = tuple(x.float().cpu() for x in (logits_p, logits_d[:1], logits_b[None],
                                                    logits_d[1:]))
        seconds[run] = time.perf_counter() - t0
    for i, what in enumerate(("prefill_logits", "decode_logits", "bucketed_prefill_logits")):
        ref = runs[ref_run][i]
        err, lp = max_err(runs["card"][i], ref), max_err(runs[lp_run][i], ref)
        ok = bool(torch.isfinite(runs["card"][i]).all()) and err <= 2 * lp + 1e-5
        checks.add(f"{name}.{what}", ok, max_abs_err=err, tolerance=2 * lp + 1e-5,
                   shape=list(runs["card"][i].shape))
    checks.add(f"{name}.inactive_row_finite", bool(torch.isfinite(runs["card"][3]).all()))
    if routed["card"]:
        # the first layer's router calls (the chunk's, the decode's, the
        # bucket's): their inputs hold no earlier routing decision, which
        # a near-tie can flip and so move a row's later inputs by O(1).
        # Per row, the 2x rule: the margin is at least twice the bf16 CPU
        # run's own probability error on that row
        calls = list(zip(routed["card"], routed[lp_run], routed[ref_run]))[::n_layers]
        rows = sure_rows = differ = 0
        for card, lp, ref in calls:
            top = torch.sort(ref, dim=-1, descending=True, stable=True)
            margin = torch.clamp_min(2 * (lp - ref).abs().amax(dim=-1), ROUTER_MARGIN)
            sure = (top.values[:, 1] - top.values[:, 2]) > margin
            want = top.indices[:, :2].sort(dim=-1).values
            got = torch.sort(card, dim=-1, descending=True, stable=True).indices[:, :2]
            differ += int(((got.sort(dim=-1).values != want).any(dim=-1) & sure).sum())
            rows += ref.shape[0]
            sure_rows += int(sure.sum())
        checks.add(f"{name}.expert_indices", differ == 0 and sure_rows > 0, rows=rows,
                   rows_past_margin=sure_rows, rows_differing=differ, calls=len(calls),
                   min_margin=ROUTER_MARGIN)
    return seconds


# the least router margin (second expert's probability over the third's)
# past which the card's routing must equal the f32 CPU run's; per row the
# check widens it to twice the bf16 CPU run's own probability error there
ROUTER_MARGIN = 1e-3


def serve(eng, cfg, seed):
    """Serve 8 greedy requests (prompts of 200-1500 tokens, 32 new tokens
    each) and time every engine step with CUDA events: a step that runs
    prefill (a chunk, or whole prompts with bucketed prefill) is a prefill
    step, the others decode steps. With chunked prefill the prefill rate is
    the prompt tokens over the prefill steps' time (those steps also decode
    the requests already active). Each request's time to first token runs
    from the moment all 8 are queued to the engine's `first_token_at`. With
    bucketed prefill the first step admits every prompt, one after the
    other, before it decodes: the last first token gives the prefill rate.
    A decode step is also timed on the host clock (it ends in the engine's
    one host read); in windows of K it emits up to K tokens a request."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(200, 1501, 8)
    n_new = 32
    prompts = {i: rng.integers(0, cfg.vocab_size, int(n)).tolist() for i, n in enumerate(lens)}
    for rid, p in prompts.items():
        eng.add_request(rid, p, n_new)
    prefill_ms, decode_ms, decode_host_ms, decode_tokens = [], [], [], 0
    stats0 = dict(eng.stats)  # the counters also hold the warm-up request
    t0 = time.perf_counter()
    while eng.has_work():
        admitted0, chunks0 = eng.stats["requests_admitted"], eng.stats["prefill_chunks"]
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        h0 = time.perf_counter()
        start.record()
        emitted = eng.step()
        end.record()
        end.synchronize()
        host_ms = 1e3 * (time.perf_counter() - h0)
        ms = start.elapsed_time(end)
        if eng.stats["requests_admitted"] > admitted0 or eng.stats["prefill_chunks"] > chunks0:
            prefill_ms.append(ms)
        else:
            decode_ms.append(ms)
            decode_host_ms.append(host_ms)
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
        decode_step_host_ms=dict(p50=percentile(decode_host_ms, 50),
                                 p90=percentile(decode_host_ms, 90)),
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


def admit_profile_requests(eng, cfg, seed, max_new):
    """The decode profiles' 8 requests (256-token prompts from seed + 2),
    admitted and prefilled by one step of a bucketed engine, which also
    decodes them once (or a window)."""
    rng = np.random.default_rng(seed + 2)
    n = eng.ecfg.max_batch
    for i in range(n):
        eng.add_request(1000 + i, rng.integers(0, cfg.vocab_size, 256).tolist(), max_new)
    eng.step()
    if len(eng.active) != n:
        raise RuntimeError(f"decode profile: {len(eng.active)} of {n} requests active")


def profile_decode(eng, cfg, seed, n_steps=3):
    """Device time of decode-only engine steps with 8 active requests, from
    a torch.profiler trace (`profiled`), with K1's and K3/K4's kernels by
    route. The engine prefills whole prompts (bucketed), so one step admits
    all 8. Each step is a graph replay; the same decode run eagerly on the
    graph's static buffers (decode_multi_step, one step) is profiled too,
    for the split by kernel should the trace not see inside the graph, and
    both are timed on the host clock (each ended by its one host read)."""
    admit_profile_requests(eng, cfg, seed, 2 * n_steps + 8)
    groups = dict(K1_GROUPS, **K3_GROUPS, append=APPEND_KERNEL)
    prof = profiled(eng.step, n_steps, groups=groups)
    s, g = eng._static, eng._graphs[(1, False)]

    def eager():
        toks, _ = eng._window_fn(1, False, s["tokens"], s["bt"], s["lens"], s["temps"],
                                 s["step"])
        return toks.cpu()

    def replay():
        g.graph.replay()
        return g.tokens.cpu()

    eager_prof = profiled(eager, n_steps, groups=groups)
    host = {}
    for name, fn in (("replay", replay), ("eager", eager), ("replay2", replay),
                     ("eager2", eager)):
        fn()
        t = []
        for _ in range(10):
            t0 = time.perf_counter()
            fn()
            t.append(1e3 * (time.perf_counter() - t0))
        host[name] = percentile(t, 50)
    eng.run()
    if prof is None:
        return None
    return dict(prof, eager_on_static_buffers=eager_prof, host_ms_p50=host,
                graph_launches_per_replay=sum(g.launches.values()))


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


# ---- the engine's serving features: graphs, windows, sampling, speculation --

# the tie rule's bound on the logits of one position computed two ways (the
# verify step's L-token tiling or another chunking against the per-step
# run): bf16 activations round differently through 32 layers, so an argmax
# may flip only where the per-step run's top two logits lie within twice
# this of each other
TIE_DELTA = 0.25


def check_graph_replay(eng, checks, name):
    """Each captured graph of the engine replayed on its static buffers
    (holding the last step's inputs) against decode_multi_step run eagerly
    on the same buffers: tokens and logits bit for bit (as int32 words, so
    that the inactive rows' values compare too). Both rewrite the same KV
    rows with the same bytes."""
    s = eng._static
    for (K, sampling), g in sorted(eng._graphs.items()):
        g.graph.replay()
        toks_g, logits_g = g.tokens.clone(), g.logits.clone()
        toks_e, logits_e = eng._window_fn(K, sampling, s["tokens"], s["bt"], s["lens"],
                                          s["temps"], s["step"])
        ok = (torch.equal(toks_g, toks_e)
              and torch.equal(logits_g.view(torch.int32), logits_e.view(torch.int32)))
        live = s["lens"] > 0
        checks.add(f"{name}.graph_equals_eager[K={K},sampling={int(sampling)}]", ok,
                   max_abs_err_live_rows=max_err(logits_g[live], logits_e[live]),
                   active_rows=int(live.sum()), launches_per_replay=sum(g.launches.values()))


def serve_recorded(eng, prompts, n_new, prefix_id=None):
    """Serve greedy requests and keep, for each token, the logits it was
    chosen from: a prefill's (the engine's _sample_first), a graphed
    per-step decode's (the graph's logits output) or a speculative verify
    position's (verify_core wrapped for the run, its calls over more than
    one token). On a data-parallel mesh the engine's graph and verify
    logits hold its replica's rows only, and it samples only its own lanes'
    first tokens: the logits kept are those of its replica's requests.
    Returns (streams,
    {(rid, index): logits (V,)}, the decode or verify steps' ms on CUDA
    events, the tokens they emitted)."""
    from xf_flash_attention_cutlass_tpu_torch.serve import engine as engine_mod

    logits, verified = {}, []
    sample_first, verify_core = eng._sample_first, engine_mod.verify_core

    def first(lg, rid, temperature):
        logits[(rid, 0)] = lg.detach().clone()
        return sample_first(lg, rid, temperature)

    def verify(*a, **kw):  # decode_core calls it too, at one token (the graph's warm-up)
        out = verify_core(*a, **kw)
        if out.shape[1] > 1:
            verified.append(out)
        return out

    eng._sample_first, engine_mod.verify_core = first, verify
    step_ms, step_tokens = [], 0
    try:
        for rid, p in prompts.items():
            eng.add_request(rid, p, n_new, prefix_id=prefix_id)
        while eng.has_work():
            before = {st["id"]: len(st["generated"]) for st in eng.active.values()}
            chunks0, admitted0 = eng.stats["prefill_chunks"], eng.stats["requests_admitted"]
            verified.clear()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            emitted = eng.step()
            end.record()
            end.synchronize()
            if not emitted:
                continue
            if (eng.stats["prefill_chunks"] == chunks0
                    and eng.stats["requests_admitted"] == admitted0):
                step_ms.append(start.elapsed_time(end))
                step_tokens += sum(len(v) for v in emitted.values())
            graph = eng._graphs.get((1, False))
            lo = eng._replica * eng.mb_local  # the replica's first row
            for slot, st in eng.active.items():
                if not lo <= slot < lo + eng.mb_local:
                    continue
                n0 = before.get(st["id"], 1)  # admitted in this step: index 0 came from prefill
                for i in range(len(st["generated"]) - n0):
                    if verified:
                        logits[(st["id"], n0 + i)] = verified[0][slot - lo, i].clone()
                    else:
                        logits[(st["id"], n0 + i)] = graph.logits[slot - lo].clone()
    finally:
        del eng._sample_first  # the class's method again (no engine-method cycle)
        engine_mod.verify_core = verify_core
    streams = {rid: list(eng.results[rid]) for rid in prompts}
    return streams, logits, step_ms, step_tokens


def tie_rule(checks, name, ref, run):
    """Hold a run's greedy streams to the per-step reference's up to their
    first difference: at every position both computed from the same context
    (each index up to the first difference) the two logit vectors differ by
    at most TIE_DELTA, and where the streams part the reference's top two
    logits lie within 2 * TIE_DELTA. Returns the summary."""
    (ref_s, ref_l), (run_s, run_l) = ref, run
    worst, parted, exact = 0.0, [], 0
    for rid, want in ref_s.items():
        got = run_s[rid]
        j = next((i for i, (a, b) in enumerate(zip(want, got)) if a != b), None)
        if j is None and len(want) == len(got):
            exact += 1
        last = len(want) - 1 if j is None else j
        for i in range(last + 1):
            if (rid, i) in ref_l and (rid, i) in run_l:
                worst = max(worst, max_err(ref_l[(rid, i)], run_l[(rid, i)]))
        if j is not None:
            top = torch.topk(ref_l[(rid, j)].float(), 2).values
            parted.append(dict(request=rid, index=j, top_two_gap=float(top[0] - top[1]),
                               delta_there=max_err(ref_l[(rid, j)], run_l[(rid, j)])))
    ok = worst <= TIE_DELTA and all(p["top_two_gap"] <= 2 * TIE_DELTA for p in parted)
    out = dict(requests=len(ref_s), exact=exact, parted=parted, worst_logit_delta=worst,
               tie_delta=TIE_DELTA)
    checks.add(f"{name}.tie_rule", ok, **out)
    return out


def repeated_prompts(rng, cfg, n, length=256, phrase=32):
    """n prompts of `length` tokens, each a random phrase repeated: prompt
    lookup finds n-grams to draft from."""
    out = {}
    for i in range(n):
        p = rng.integers(0, cfg.vocab_size, phrase).tolist()
        out[i] = (p * -(-length // phrase))[:length]
    return out


def sampling_times(cfg, seed, reps=20):
    """sample_tokens on 8 rows of the vocabulary's f32 logits on the card:
    the argmax alone, then each route at temperature 0.8, each captured in
    a CUDA graph as in the engine's decode step and its replays timed with
    CUDA events (a route is a few hundred small kernels, most of them the
    Philox noise's elementwise int64 ops: launched eagerly, the host could
    not queue them as fast as the card runs them). Returns {route: ms}."""
    from xf_flash_attention_cutlass_tpu_torch.serve.engine import sample_tokens

    gen = torch.Generator(device="cuda").manual_seed(seed)
    logits = torch.randn((8, cfg.vocab_size), generator=gen, device="cuda")
    temps = torch.full((8,), 0.8, device="cuda")
    step = torch.zeros((), dtype=torch.int64, device="cuda")
    routes = dict(greedy=dict(temperature=None), temperature=dict(), top_k50=dict(top_k=50),
                  top_k50_top_p09=dict(top_k=50, top_p=0.9),
                  top_p09_prefix128=dict(top_p=0.9),
                  top_p09_full_sort=dict(top_p=0.9, approx_top_k=False))
    out = {}
    for name, kw in routes.items():
        kw = dict(dict(temperature=temps, step=step, seed=seed), **kw)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            sample_tokens(logits, **kw)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            sample_tokens(logits, **kw)
        graph.replay()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            graph.replay()
        end.record()
        end.synchronize()
        out[name] = start.elapsed_time(end) / reps
        del graph
    return out


# the Gumbel noise's bound between the card and the CPU: each side rounds
# its two logs within a few ulp, and the noise reaches about 16 in size
NOISE_TOL = 1e-5


def check_sampling_on_cpu(cfg, seed, checks, device="cuda"):
    """sample_tokens on the card against the same call on the CPU: 8 rows
    of the vocabulary's f32 logits, mixed temperatures (two greedy rows),
    a step word per row (two past 2**31, wrapped by the counter's mask) and
    a 64-bit seed, on both lanes, for every route. The Philox uniforms are
    integer math and must be bit-equal; the noise within NOISE_TOL (its logs
    round per library); the tokens equal. Returns {route: tokens equal}."""
    from xf_flash_attention_cutlass_tpu_torch.serve.engine import (
        gumbel_noise,
        philox_uniform,
        sample_tokens,
    )

    gen = torch.Generator(device=device).manual_seed(seed + 6)
    logits = torch.randn((8, cfg.vocab_size), generator=gen, device=device)
    temps = torch.tensor([0.0, 0.5, 0.8, 1.3, 0.8, 2.0, 0.0, 1.0], device=device)
    steps = torch.tensor([0, 1, 7, 2**31 + 5, 2**32 + 3, 12345, 99, 3], device=device)
    key = (1 << 40) + seed
    routes = dict(temperature=dict(), top_k50=dict(top_k=50), top_p09_prefix128=dict(top_p=0.9),
                  top_k50_top_p09=dict(top_k=50, top_p=0.9),
                  top_p09_full_sort=dict(top_p=0.9, approx_top_k=False))
    out = {}
    for lane in (0, 1):
        args = (8, cfg.vocab_size, steps, lane, key)
        u_card, u_cpu = philox_uniform(*args, device), philox_uniform(*args, "cpu")
        g_card, g_cpu = gumbel_noise(*args, device).cpu(), gumbel_noise(*args, "cpu")
        checks.add(f"serve_sampled.noise_equals_cpu[lane={lane}]",
                   torch.equal(u_card.cpu().view(torch.int32), u_cpu.view(torch.int32))
                   and max_err(g_card, g_cpu) <= NOISE_TOL,
                   max_abs_err=max_err(g_card, g_cpu), tolerance=NOISE_TOL,
                   noise_bit_equal_share=float((g_card.view(torch.int32)
                                                == g_cpu.view(torch.int32)).float().mean()))
        for name, kw in routes.items():
            kw = dict(temperature=temps, step=steps, seed=key, lane=lane, **kw)
            card = sample_tokens(logits, **kw).cpu()
            cpu = sample_tokens(logits.cpu(), **dict(kw, temperature=temps.cpu(),
                                                     step=steps.cpu()))
            same = torch.equal(card, cpu)
            out[f"{name}[lane={lane}]"] = same
            checks.add(f"serve_sampled.tokens_equal_cpu[{name},lane={lane}]", same,
                       card=card.tolist(), cpu=cpu.tolist())
    return out


def profile_window(eng, cfg, seed, n_windows=2):
    """profile_decode's 8 requests (256-token prompts, the same tokens) on
    an engine with multi_step = 4: device time and kernel launches a window
    from a profiler trace, and the host time of a window, for the device
    time a token beside the per-step graph's on the same contexts."""
    admit_profile_requests(eng, cfg, seed, 4 * (2 * n_windows + 2))
    prof = profiled(eng.step, n_windows, groups=dict(K1_GROUPS, **K3_GROUPS))
    host = []
    for _ in range(n_windows):
        t0 = time.perf_counter()
        eng.step()
        host.append(1e3 * (time.perf_counter() - t0))
    eng.run()
    return None if prof is None else dict(prof, host_ms=host)


def sampled_run(eng, cfg, seed, n_new=16):
    """8 requests of serve's prompts at temperature 0.8 (the engine's top_k
    and top_p); their streams, each token checked to lie in the vocabulary."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(200, 1501, 8)
    prompts = {i: rng.integers(0, cfg.vocab_size, int(n)).tolist() for i, n in enumerate(lens)}
    for rid, p in prompts.items():
        eng.add_request(rid, p, n_new, temperature=0.8)
    eng.run()
    return {rid: list(eng.results[rid]) for rid in prompts}


def serve_features(params, cfg, ecfg, seed, checks, paths, per_step_chunked):
    """The engine's features at the serving configuration: (1) the 8
    chunked serving requests again in windows of 4 (streams equal to the
    per-step run's, `per_step_chunked`); (2) a sampled run (top-k 50, top-p
    0.9, temperature 0.8, bucketed) in windows of 4 and again per step:
    equal; (3) speculate_k = 3 on prompts of repeated phrases against the
    per-step run, under the tie rule; (4) a 512-token registered prefix
    against the per-step run over prefix + prompt, under the tie rule. Each
    engine's graphs are held to the eager step; profile_decode's requests
    are profiled in windows of 4 too. Returns the report."""
    from xf_flash_attention_cutlass_tpu_torch.serve.engine import DecodeEngine

    report = {}
    bucketed = dataclasses.replace(ecfg, prefill_chunk=None)

    eng = DecodeEngine(params, cfg, dataclasses.replace(ecfg, multi_step=4))
    windowed, paths["serve_multi_step"] = drive("serve_multi_step",
                                                lambda: serve(eng, cfg, seed))
    same = {rid: eng.results[rid] == per_step_chunked[rid] for rid in per_step_chunked}
    checks.add("serve_multi_step.streams_equal_per_step", all(same.values()), per_request=same)
    check_graph_replay(eng, checks, "serve_multi_step")
    report["serve_multi_step"] = windowed
    print(json.dumps({"serve_multi_step": windowed}), flush=True)
    del eng
    torch.cuda.empty_cache()

    eng = DecodeEngine(params, cfg, dataclasses.replace(bucketed, multi_step=4))
    report["decode_window_profile"] = profile_window(eng, cfg, seed)
    print(json.dumps({"decode_window_profile": report["decode_window_profile"]}), flush=True)
    del eng
    torch.cuda.empty_cache()

    sampling = dataclasses.replace(bucketed, top_k=50, top_p=0.9, sample_seed=seed)
    eng = DecodeEngine(params, cfg, dataclasses.replace(sampling, multi_step=4))
    a, paths["serve_sampled"] = drive("serve_sampled", lambda: sampled_run(eng, cfg, seed))
    check_graph_replay(eng, checks, "serve_sampled")
    del eng
    eng = DecodeEngine(params, cfg, sampling)
    b = sampled_run(eng, cfg, seed)
    del eng
    torch.cuda.empty_cache()
    checks.add("serve_sampled.reproducible", a == b,
               in_vocabulary=all(0 <= t < cfg.vocab_size for s in a.values() for t in s),
               distinct_tokens=len({t for s in a.values() for t in s}))
    report["serve_sampled"] = dict(streams_equal=a == b, tokens=sum(map(len, a.values())),
                                   sampling_ms=sampling_times(cfg, seed),
                                   equals_cpu=check_sampling_on_cpu(cfg, seed, checks))
    print(json.dumps({"serve_sampled": report["serve_sampled"]}), flush=True)

    rng = np.random.default_rng(seed + 4)
    prompts = repeated_prompts(rng, cfg, ecfg.max_batch)
    eng = DecodeEngine(params, cfg, bucketed)
    ref_s, ref_l, ref_ms, ref_tok = serve_recorded(eng, prompts, 24)
    del eng
    eng = DecodeEngine(params, cfg, dataclasses.replace(bucketed, speculate_k=3))
    (spec_s, spec_l, spec_ms, spec_tok), paths["serve_speculative"] = drive(
        "serve_speculative", lambda: serve_recorded(eng, prompts, 24))
    report["serve_speculative"] = dict(
        tie_rule=tie_rule(checks, "serve_speculative", (ref_s, ref_l), (spec_s, spec_l)),
        stats=dict(eng.stats), per_step_ms=dict(p50=percentile(ref_ms, 50),
                                                p90=percentile(ref_ms, 90)),
        verify_step_ms=dict(p50=percentile(spec_ms, 50), p90=percentile(spec_ms, 90)),
        per_step_tok_s=ref_tok / (sum(ref_ms) / 1e3), verify_tok_s=spec_tok / (sum(spec_ms) / 1e3),
        tokens_per_verify_step=spec_tok / len(spec_ms))
    print(json.dumps({"serve_speculative": report["serve_speculative"]}), flush=True)
    del eng, ref_l, spec_l
    torch.cuda.empty_cache()

    rng = np.random.default_rng(seed + 5)
    prefix = rng.integers(0, cfg.vocab_size, 512).tolist()
    prompts = {i: rng.integers(0, cfg.vocab_size, int(n)).tolist()
               for i, n in enumerate(rng.integers(100, 401, ecfg.max_batch))}
    eng = DecodeEngine(params, cfg, ecfg)
    ref_s, ref_l, _, _ = serve_recorded(eng, {r: prefix + p for r, p in prompts.items()}, 16)
    del eng
    eng = DecodeEngine(params, cfg, ecfg)

    def prefixed():
        eng.register_prefix("sys", prefix)
        out = serve_recorded(eng, prompts, 16, prefix_id="sys")
        eng.release_prefix("sys")
        return out

    (pre_s, pre_l, _, _), paths["serve_prefix"] = drive("serve_prefix", prefixed)
    checks.add("serve_prefix.pages_returned", eng.pool.free_pages() == ecfg.num_pages,
               free_pages=eng.pool.free_pages())
    report["serve_prefix"] = dict(
        tie_rule=tie_rule(checks, "serve_prefix", (ref_s, ref_l), (pre_s, pre_l)),
        stats=dict(eng.stats), prefix_tokens=len(prefix))
    print(json.dumps({"serve_prefix": report["serve_prefix"]}), flush=True)
    del eng, ref_l, pre_l
    torch.cuda.empty_cache()
    return report


# ---- phase 6: the MoE family at Mixtral-8x7B geometry ------------------------

MOE_PAGES = 64  # page-256 FP8 pages of the MoE engines: the 8 prompts need 28


def moe_expert_offsets(params, cfg, gen, checks):
    """K3 on the expert stacks' (L * E, d_in, d_out) views at the first and
    the last entry (l * E + e = 255: 255 x 58.7 MB past the base, beyond
    2**31 bytes) and m = 8 (the decode route) and 80 (a chunk's capacity,
    the wgmma route): each view shares the stack's storage at the entry's
    byte offset, and the kernel's output passes the 2x rule against the f32
    product (plain version as the low-precision oracle)."""
    from xf_flash_attention_cutlass_tpu_torch.quant.linear import (
        quantized_matmul,
        quantized_matmul_ref,
    )

    E = cfg.n_experts
    out = {}
    for name in ("w_gate", "w_down"):
        wq, s = params["layers"][name]
        L, _, K, N = wq.shape
        flat, sflat = wq.view(L * E, K, N), s.view(L * E, N)
        for idx in (0, L * E - 1):
            offset = flat[idx].data_ptr() - wq.data_ptr()
            for m in (8, 80):
                x = torch.randn((m, K), generator=gen, device="cuda").bfloat16()
                y = quantized_matmul(x, flat, sflat, layer_idx=idx)
                y32 = (x.float() @ flat[idx].float()) * sflat[idx]
                err = max_err(y, y32)
                tol = 2 * max_err(quantized_matmul_ref(x, flat[idx], sflat[idx]), y32) + 1e-5
                ok = (err <= tol and offset == idx * K * N
                      and flat.data_ptr() == wq.data_ptr())
                checks.add(f"serve_moe.expert_view[{name},idx={idx},m={m}]", ok,
                           max_abs_err=err, tolerance=tol, byte_offset=offset)
                out[f"{name}.{idx}.m{m}"] = dict(err=err, tol=tol, byte_offset=offset)
    return out


def moe_train(gen, cfg, seed, lr=0.005):
    """Two plain SGD steps of moe_loss_fn on one batch (b = 1, 512 tokens
    from the seed) with bf16 parameters at cfg's widths, then the loss once
    more: every loss finite and below the one before. Returns (ok, report,
    the trained parameters, detached)."""
    from xf_flash_attention_cutlass_tpu_torch.models.moe import init_moe_params, moe_loss_fn

    params = init_moe_params(gen, cfg)
    leaves = [params["embed"], params["final_norm"], params["lm_head"],
              *params["layers"].values()]
    for t in leaves:
        t.requires_grad_(True)
    rng = np.random.default_rng(seed + 7)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 513))).cuda()
    losses, step_ms = [], []
    for i in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = moe_loss_fn(params, tokens, cfg)
        if i < 2:
            grads = torch.autograd.grad(loss, leaves)
            with torch.no_grad():
                for t, g in zip(leaves, grads):
                    t.sub_(g, alpha=lr)
            del grads
        losses.append(float(loss.detach()))
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
    peak = torch.cuda.max_memory_allocated() / 1e9
    for t in leaves:
        t.requires_grad_(False)
    ok = all(math.isfinite(x) for x in losses) and all(b < a for a, b in zip(losses, losses[1:]))
    return ok, dict(layers=cfg.n_layers, tokens=512, lr=lr, losses=losses, step_ms=step_ms,
                    peak_memory_gb=peak), params


def moe_bf16_engine(params, cfg, checks, seed):
    """bf16 MoE params (the trained 2-layer ones: plain experts, their
    einsums in torch, the attention projections on K3 with bf16 weights)
    served by a bucketed engine over FP8 page-256 KV: 8 requests of 64-256
    prompt tokens, 8 new tokens each, every token in the vocabulary, the
    graph equal to the eager step. Returns the streams' lengths."""
    from xf_flash_attention_cutlass_tpu_torch.serve import DecodeEngine, EngineConfig

    eng = DecodeEngine(params, cfg, EngineConfig(kv_quant="fp8_e4m3", page_size=256,
                                                 num_pages=16, max_seq=1024, max_batch=8))
    rng = np.random.default_rng(seed + 8)
    for i in range(8):
        eng.add_request(i, rng.integers(0, cfg.vocab_size, int(rng.integers(64, 257))).tolist(), 8)
    out = eng.run()
    ok = all(len(out[i]) == 8 and all(0 <= t < cfg.vocab_size for t in out[i]) for i in range(8))
    checks.add("serve_moe_bf16.streams_complete", ok, lens=[len(out.get(i, [])) for i in range(8)])
    check_graph_replay(eng, checks, "serve_moe_bf16")
    del eng
    torch.cuda.empty_cache()
    return {i: len(out[i]) for i in range(8)}


def moe_checkpoint(params, cfg, ecfg, prompts, want, checks):
    """A chunked engine over the serving prompts, saved (include_params=False)
    once every prefill is done and 4 decode steps later, into a temporary
    directory; loaded into a fresh engine over the same params, whose
    streams must equal the uninterrupted run's (`want`), token for token;
    loaded again, whose pools must equal the saved engine's byte for byte.
    Returns the file's size and the save and load seconds."""
    import tempfile

    from xf_flash_attention_cutlass_tpu_torch.serve import DecodeEngine, load_engine, save_engine

    eng = DecodeEngine(params, cfg, ecfg)
    for rid, p in prompts.items():
        eng.add_request(rid, p, len(want[rid]))
    while eng.queue or any(st is not None for st in eng._prefills):
        eng.step()
    for _ in range(4):
        eng.step()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "moe.npz")
        t0 = time.perf_counter()
        save_engine(eng, path)
        out["save_s"] = time.perf_counter() - t0
        out["file_bytes"] = os.path.getsize(path)
        t0 = time.perf_counter()
        resumed = load_engine(path, params=params)
        torch.cuda.synchronize()
        out["load_s"] = time.perf_counter() - t0
        streams = resumed.run()
        del resumed
        same = {rid: list(streams[rid]) == want[rid] for rid in want}
        checks.add("serve_moe.checkpoint.resumed_streams_equal", all(same.values()),
                   per_request=same)
        again = load_engine(path, params=params)
        equal = {k: bool(torch.equal(v.view(torch.uint8), again.pools[k].view(torch.uint8)))
                 for k, v in eng.pools.items()}
        checks.add("serve_moe.checkpoint.pools_byte_equal", all(equal.values()), pools=equal,
                   allocator_equal=bool(np.array_equal(again.pool.snapshot(),
                                                       eng.pool.snapshot())))
        del again
    del eng
    torch.cuda.empty_cache()
    return out


def moe_profile(eng, cfg, seed, checks):
    """One decode step of 8 active requests (profile_decode's 256-token
    prompts, bucketed: one step admits all 8) under a profiler trace: its
    device time, K3's kernels by route, the launches the graph replay adds
    to the counters (K3's by route), then five steps on the host clock: busy
    share (device time over the host step) and tokens/s; and the MoE MLP's
    plain parts alone (moe_mlp_parts). The decode kernel's split counters
    must read 0 after the steps."""
    from xf_flash_attention_cutlass_tpu_torch import _build
    from xf_flash_attention_cutlass_tpu_torch.quant.linear import decode_counters

    admit_profile_requests(eng, cfg, seed, 16)
    eng.step()  # warm
    before = dict(_build.LAUNCHES)
    eng.step()
    launches = {k: v - before.get(k, 0) for k, v in _build.LAUNCHES.items()
                if v != before.get(k, 0)}
    groups = dict(K3_GROUPS, k1_decode="paged_decode_kernel",
                  k1_combine="paged_combine_kernel", append=APPEND_KERNEL)
    prof = profiled(eng.step, 1, groups=groups)
    host = []
    for _ in range(5):
        t0 = time.perf_counter()
        eng.step()
        host.append(1e3 * (time.perf_counter() - t0))
    counters = decode_counters(torch.device("cuda"))
    checks.add("serve_moe.decode_counters_zero_after_steps", int(counters.abs().sum()) == 0,
               nonzero=int((counters != 0).sum()))
    active = len(eng.active)
    eng.run()
    host_ms = percentile(host, 50)
    out = dict(active=active, host_ms_p50=host_ms, tokens_per_s=active / (host_ms / 1e3),
               wrapper_launches_per_step={k: v for k, v in launches.items()
                                          if k.startswith("qmm") or k.startswith("graph")})
    if prof is not None:
        out.update(prof, busy_share=prof["device_ms_per_step"] / host_ms)
    out["mlp_parts"] = moe_mlp_parts(eng.params, cfg)
    return out


def moe_mlp_parts(params, cfg, rows=8):
    """Device ms a decode step (all layers) of the MoE MLP's parts other
    than K3, at the decode's shapes (8 rows, capacity 8), each captured in a
    CUDA graph of cfg.n_layers calls as the decode step runs them and its
    replays profiled: the router (rms_norm, the f32 product, softmax), the
    dispatch (top_k_dispatch: sort, cumsum, one-hots), the dispatch and
    combine einsums, and the SwiGLU's silu and product between K3's calls."""
    import torch.nn.functional as F

    from xf_flash_attention_cutlass_tpu_torch.models.llama import rms_norm
    from xf_flash_attention_cutlass_tpu_torch.models.moe import expert_capacity, top_k_dispatch

    gen = torch.Generator(device="cuda").manual_seed(11)
    d, E, C = cfg.dim, cfg.n_experts, expert_capacity(cfg, rows)
    x = torch.randn((1, rows, d), generator=gen, device="cuda").bfloat16()
    norm, router = params["layers"]["mlp_norm"][0], params["layers"]["router"][0]
    flat = rms_norm(x, norm, cfg.rms_eps).reshape(rows, d)
    probs = torch.softmax(flat.float() @ router, dim=-1)
    dispatch, combine, _ = top_k_dispatch(probs, cfg.top_k, C)
    out = torch.randn((E, C, d), generator=gen, device="cuda").bfloat16()
    g = torch.randn((C, cfg.ffn_dim), generator=gen, device="cuda").bfloat16()
    parts = dict(
        router=lambda: torch.softmax(rms_norm(x, norm, cfg.rms_eps).reshape(rows, d).float()
                                     @ router, dim=-1),
        dispatch=lambda: top_k_dispatch(probs, cfg.top_k, C),
        einsums=lambda: (torch.einsum("nec,nd->ecd", dispatch.bfloat16(), flat),
                         torch.einsum("nec,ecd->nd", combine.bfloat16(), out)),
        swiglu=lambda: [F.silu(g) * g for _ in range(E)],
    )
    ms = {}
    for name, fn in parts.items():
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(cfg.n_layers):
                fn()
        prof = profiled(graph.replay, 3)
        ms[name] = None if prof is None else prof["device_ms_per_step"]
        del graph
    return ms


def serve_moe(gen, checks, paths, seed):
    """The MoE family served at Mixtral-8x7B geometry (all 32 layers, full
    width, random INT8 weights from the seed, drawn a layer at a time), an
    FP8 page-256 KV cache, greedy, every decode step a graph replay:
    (1) the reference check of the cores, cut to 2 layers, against the CPU,
    routing included, and K3 on the expert views at l * E + e; (2) the 8
    serving prompts with 32 new tokens each, chunked (256-token chunks) and
    bucketed, each a main path, their graphs held to the eager step, the
    tie rule between their streams measured (not a gate: routing flips at
    near-ties move the logits by O(1)); (3) a chunked engine
    saved mid-stream and resumed; (4) one decode step profiled; (5) two SGD
    steps of the MoE loss at 2 layers, whose bf16 params then serve through
    the engine too. Returns the report."""
    from xf_flash_attention_cutlass_tpu_torch.models.moe import (
        MoEConfig,
        init_moe_params_quantized,
    )
    from xf_flash_attention_cutlass_tpu_torch.serve import DecodeEngine, EngineConfig
    from xf_flash_attention_cutlass_tpu_torch.serve.checkpoint import _flatten

    cfg = MoEConfig.mixtral8x7b_geometry()
    report = {}
    t0 = time.perf_counter()
    params = init_moe_params_quantized(gen, cfg)
    torch.cuda.synchronize()
    report["init_s"] = time.perf_counter() - t0
    report["params_gb"] = sum(t.numel() * t.element_size() for t in _flatten(params)) / 1e9
    report["reference_check_s"] = reference_check(params, cfg, checks, seed, "moe_reference")
    report["expert_views"] = moe_expert_offsets(params, cfg, gen, checks)
    checks.raise_on_failure("moe reference check")
    print(json.dumps({"serve_moe_init": report}), flush=True)

    rng = np.random.default_rng(seed)
    lens = rng.integers(200, 1501, 8)
    prompts = {i: rng.integers(0, cfg.vocab_size, int(n)).tolist() for i, n in enumerate(lens)}
    n_new = 32
    ecfg = EngineConfig(kv_quant="fp8_e4m3", page_size=256, num_pages=MOE_PAGES, max_seq=4096,
                        max_batch=8, prefill_chunk=256)
    runs = {}
    for mode, e in (("chunked", ecfg), ("bucketed", dataclasses.replace(ecfg, prefill_chunk=None))):
        eng = DecodeEngine(params, cfg, e)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        (streams, logits, step_ms, step_tok), paths[f"serve_moe_{mode}"] = drive(
            f"serve_moe_{mode}", lambda: serve_recorded(eng, prompts, n_new))
        wall = time.perf_counter() - t0
        bad = {rid: s for rid, s in streams.items()
               if len(s) != n_new or not all(0 <= t < cfg.vocab_size for t in s)}
        checks.add(f"serve_moe_{mode}.streams_complete", not bad, bad=bad)
        check_graph_replay(eng, checks, f"serve_moe_{mode}")
        runs[mode] = (streams, logits)
        report[f"serving_{mode}"] = dict(
            prompt_tokens=int(lens.sum()), new_tokens_per_request=n_new, wall_s=wall,
            decode_only_steps=len(step_ms),
            decode_step_ms=dict(p50=percentile(step_ms, 50), p90=percentile(step_ms, 90)),
            decode_tok_s=step_tok / (sum(step_ms) / 1e3) if step_ms else None,
            peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
            launches=paths[f"serve_moe_{mode}"], stats=dict(eng.stats))
        print(json.dumps({f"serve_moe_{mode}": report[f"serving_{mode}"]}), flush=True)
        if mode == "chunked":
            del eng
            torch.cuda.empty_cache()
    # measured, not a gate: top-k routing is discontinuous, so the rounding
    # that separates a chunked prefill from a bucketed one (an FP8 cache or
    # the prompt's own K/V under the attention) flips a token's experts where
    # its router is near a tie, and the logits downstream then move by O(1)
    # (PERF.md, the MoE serving path)
    report["tie_rule"] = tie_rule(Checks(), "serve_moe.measured", runs["chunked"],
                                  runs["bucketed"])
    print(json.dumps({"serve_moe_tie_rule": report["tie_rule"]}), flush=True)
    want = runs["chunked"][0]
    del runs
    checks.raise_on_failure("moe serving")

    # 12. expert parallelism on these params (the chunked engine is gone)
    t12 = time.perf_counter()
    report["serve_mesh_ep"] = serve_mesh_ep(params, cfg, ecfg, prompts, n_new, want, eng, checks,
                                            paths)
    checks.raise_on_failure("serve_mesh_ep")
    phase12_s = time.perf_counter() - t12

    report["checkpoint"] = moe_checkpoint(params, cfg, ecfg, prompts, want, checks)
    print(json.dumps({"serve_moe_checkpoint": report["checkpoint"]}), flush=True)
    report["decode_profile"] = moe_profile(eng, cfg, seed, checks)
    print(json.dumps({"moe_decode_profile": report["decode_profile"]}), flush=True)
    del eng, params
    torch.cuda.empty_cache()
    checks.raise_on_failure("moe checkpoint and profile")

    torch.cuda.reset_peak_memory_stats()
    cfg2 = dataclasses.replace(cfg, n_layers=2)
    (ok, training, trained), paths["train_moe"] = drive(
        "train_moe", lambda: moe_train(gen, cfg2, seed))
    checks.add("train_moe.loss_falls", ok, losses=training["losses"])
    report["training"] = training
    print(json.dumps({"train_moe": training}), flush=True)
    report["bf16_engine"] = moe_bf16_engine(trained, cfg2, checks, seed)
    del trained
    torch.cuda.empty_cache()
    checks.raise_on_failure("moe training and the bf16 engine")

    # 12, continued: ep training at 2 layers, then the two-process NCCL probe
    t12 = time.perf_counter()
    report["train_mesh_ep"] = mesh_train_ep(gen, cfg, seed, checks, paths)
    print(json.dumps({"train_mesh_ep": report["train_mesh_ep"]}), flush=True)
    checks.raise_on_failure("train_mesh_ep")
    report["nccl_two_process_probe"] = nccl_two_process_probe()
    print(json.dumps({"nccl_two_process_probe": report["nccl_two_process_probe"]}), flush=True)
    report["phase12_s"] = phase12_s + time.perf_counter() - t12
    return report



# ---- phase 7: fp16 and f32 (K1, the append kernel, K3/K4) -----------------------

F16, F32, FP8 = torch.float16, torch.float32, torch.float8_e4m3fn


def flex_yardstick(q, kp, vp, ks, vs, bt, lens, causal=True, window=(-1, -1), softcap=0.0,
                   alibi_slopes=None, cache_leftpad=None):
    """(T, call) of the options' library yardstick: flex_attention under
    torch.compile over the first T keys of each block-table row (T the
    largest kv_len rounded up to a page), gathered and dequantized to q's
    dtype (bf16 or fp16) as sdpa_over_pages does but not repeated over the GQA group
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
        return x.to(q.dtype)

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


def flex_library(q, kp, vp, ks, vs, bt, lens, opts, timed):
    """flex_yardstick's call on one layer's pools for a timed options row,
    else None; a compile failure prints its text and gives None."""
    if not timed:
        return None
    try:
        return flex_yardstick(q, kp, vp, ks, vs, bt, lens, **opts)[1]
    except Exception as e:  # the row then has no library time; the text says why
        print(json.dumps({"flex_attention_error": f"{type(e).__name__}: {e}"[:2000]}),
              flush=True)
        return None


def check_k1_call(checks, timer, name, q, kp, vp, ks, vs, bt, lens, layer_idx=None, timed=False,
                  library=None, **opts):
    """One K1 call of any route and dtype under the 2x rule against its plain
    version and paged_attention_oracle (float64 for f32 queries): it must
    launch the route paged_plan names once, under its label (route_label);
    rows that see no key give O = 0 and LSE = -inf. Timed: its row (ms,
    plain_ms, bound, library_ms: `library`'s time, or None)."""
    from xf_flash_attention_cutlass_tpu_torch import _build
    from xf_flash_attention_cutlass_tpu_torch.ops.paged import (
        has_options,
        paged_attention,
        paged_attention_ref,
        paged_plan,
        route_label,
    )
    from xf_flash_attention_cutlass_tpu_torch.utils.testing import paged_attention_oracle

    sq, h = q.shape[1], q.shape[2]
    route, splits = paged_plan(q.shape, kp.shape, kp.dtype, bt.shape[1], **opts, q_dtype=q.dtype)
    full = dict(causal=True, window=(-1, -1), softcap=0.0, alibi_slopes=None, cache_leftpad=None)
    full.update(opts)
    label = route_label(route, sq * (h // kp.shape[-3]), has_options(**full), q.dtype)
    ref_dt = torch.float64 if q.dtype == F32 else torch.float32
    sc = {} if ks is None else dict(k_scales=ks, v_scales=vs)
    pick = (lambda x: x) if layer_idx is None else (lambda x: None if x is None else x[layer_idx])
    sc1 = {} if ks is None else dict(k_scales=pick(ks), v_scales=pick(vs))

    def kernel():
        return paged_attention(q, kp, vp, bt, lens, layer_idx=layer_idx, **sc, **opts)

    def plain():
        return paged_attention_ref(q, pick(kp), pick(vp), bt, lens, num_splits=splits, **sc1,
                                   **opts)

    n0 = _build.LAUNCHES[label]
    o, lse = kernel()
    launched = _build.LAUNCHES[label] - n0 == 1
    o_plain, _ = plain()
    o_ref, l_ref = paged_attention_oracle(q, pick(kp), pick(vp), bt, lens, ref_dtype=ref_dt,
                                          **sc1, **opts)
    o_lp, _ = paged_attention_oracle(q, pick(kp), pick(vp), bt, lens, upcast=False,
                                     ref_dtype=ref_dt, **sc1, **opts)
    torch.cuda.synchronize()
    tol = 2 * max_err(o_lp, o_ref) + 1e-5
    err, plain_err = max_err(o, o_ref), max_err(o, o_plain)
    dead = torch.isneginf(l_ref)
    dead_ok = torch.equal(torch.isneginf(lse), dead) and bool(
        (o.transpose(1, 2)[dead] == 0).all())
    ok = (bool(torch.isfinite(o).all()) and o.dtype == q.dtype and err <= tol
          and plain_err <= tol and dead_ok and launched)
    checks.add(name, ok, max_abs_err=plain_err, tolerance=tol, err_vs_oracle=err, route=route,
               label=label, num_splits=splits, launched=launched, dead_rows=int(dead.sum()))
    if not timed:
        return None
    return dict(ms=timer.ms(kernel), plain_ms=timer.ms(plain, PLAIN_REPS),
                bound=k1_bound(q, kp, ks, bt, lens, **opts),
                library_ms=None if library is None else timer.ms(library),
                err=plain_err, tol=tol, splits=splits, route=route)


def odd_page_inputs(gen, cfg, dtype, page=12):
    """K1's decode shape (b = 8, kv_lens 200-1533, the last slot inactive)
    over pools of `dtype` with pages of no whole TMA box (12 keys): the WMMA
    kernel's. Returns (q, k_pool, v_pool, bt, lens)."""
    h, h_k, d, b = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, 8
    max_pages = -(-1533 // page)
    n_pages = b * max_pages
    kp, vp, _, _ = kv_pools(gen, dtype, 1, n_pages, h_k, page, d)
    kp, vp = kp[0], vp[0]
    bt = torch.randperm(n_pages, generator=gen, device="cuda").int().reshape(b, max_pages)
    lens = torch.randint(200, 1533, (b,), generator=gen, device="cuda").int()
    lens[-1] = 0
    bt[-1] = n_pages
    q = torch.randn((b, 1, h, d), generator=gen, device="cuda").to(dtype)
    return q, kp, vp, bt, lens


def check_dtype_kernels(gen, timer, checks, cfg):
    """The fp16 and f32 instantiations of K1, the append kernel and K3/K4
    against their plain versions, at the serving paths' shapes and in the
    crosses no engine path runs. K1 (check_paged_attention): decode and a
    256-token chunk with fp16 queries over fp8, fp16 and int8 pools and f32
    queries over f32, fp8 and int8 pools; fp16 with each option and all four
    at the api decode shape (over an fp16 dense cache) and at the chunk shape
    (fp8 pools), f32 with all four at both (over f32 and fp8); an fp16 decode
    over page-12 pools (the WMMA kernel); the combine kernel writing fp16 and
    f32. The append: fp16 rows into fp8, fp16 and int8 pools, f32 rows into
    f32, int8 and fp8, decode and chunk, and both at page 32 (K6's work), bit
    for bit. K3/K4 (check_qmm): fp16 activations over int8 (timed), fp8 and
    fp16 weights on the decode and wgmma kernels, stacked and single, and
    the WMMA kernels forced; f32 activations over f32 (timed), int8 and fp8
    weights, stacked and single. The 2x rule throughout (against float64
    oracles for f32), with SDPA / cuBLAS (no TF32) in the working dtype as
    the library yardsticks. Returns the timed rows by launch label."""
    from xf_flash_attention_cutlass_tpu_torch._build import LABEL_SUFFIX
    from xf_flash_attention_cutlass_tpu_torch.ops.paged import paged_attention

    measured = {}
    d, hd = cfg.dim, cfg.head_dim
    layer_shapes = [(d, cfg.n_heads * hd), (d, cfg.n_kv_heads * hd), (d, cfg.n_kv_heads * hd),
                    (cfg.n_heads * hd, d), (d, cfg.ffn_dim), (d, cfg.ffn_dim), (cfg.ffn_dim, d)]
    # the untimed crosses: the q, k and down projections' shapes (each K and N)
    few = [(d, cfg.n_heads * hd), (d, cfg.n_kv_heads * hd), (cfg.ffn_dim, d)]
    # K1 at the engine's shapes: timed over the pools each serving path uses
    for q_dt, pools in ((F16, (FP8, F16, torch.int8)), (F32, (F32, FP8, torch.int8))):
        for kv in pools:
            for phase in ("decode", "prefill"):
                timed = kv == pools[0]
                r = check_paged_attention(gen, timer, checks, kv, phase, cfg, q_dt, timed)
                if r is not None:
                    label = ({"decode": "paged_attention.decode", "prefill":
                              "paged_attention.prefill.wgmma"}[phase] + ".f16"
                             if q_dt == F16 else f"paged_attention.{phase}.f32")
                    measured[label] = r
    for out_dt in (F16, F32):
        label = "paged_attention.decode" + LABEL_SUFFIX[out_dt]
        measured["paged_attention.combine" + LABEL_SUFFIX[out_dt]] = check_paged_combine(
            gen, timer, checks, cfg, measured[label]["splits"], out_dt)
    # K1's options: fp16 on both Hopper routes, f32 on the f32 kernel
    for dt in (F16, F32):
        q, kp, vp, bt, lens, full = options_decode_inputs(gen, cfg, dt)
        cases = ([(n, {n: x}) for n, x in full.items()] if dt == F16 else []) + [("all", full)]
        for name, opts in cases:
            timed = name == "all" and dt == F16
            r = check_k1_call(checks, timer, f"paged_attention.decode.options[{DT_TAG[dt]},{name}]",
                              q, kp, vp, None, None, bt, lens, timed=timed,
                              library=flex_library(q, kp, vp, None, None, bt, lens, opts,
                                                   timed),
                              **opts)
            if r is not None:
                r["ms_no_options"] = timer.ms(lambda: paged_attention(q, kp, vp, bt, lens))
                measured["paged_attention.decode.options.f16"] = r
        del kp, vp
        q, kp, vp, ks, vs, bt, lens, full = options_chunk_inputs(gen, FP8, cfg, dt)
        cases = ([(n, {n: x}) for n, x in full.items()] if dt == F16 else []) + [
            ("all", full), ("right_window", dict(causal=False, window=(-1, 37)))]
        for name, opts in cases:
            timed = name == "all" and dt == F16
            library = flex_library(q, kp[1], vp[1], ks[1], vs[1], bt, lens, opts, timed)
            r = check_k1_call(checks, timer,
                              f"paged_attention.prefill.options[{DT_TAG[dt]}/fp8,{name}]",
                              q, kp, vp, ks, vs, bt, lens, 1, timed=timed, library=library,
                              **opts)
            if r is not None:
                measured["paged_attention.prefill.options.f16"] = r
        del kp, vp, ks, vs
    # an odd page: the WMMA kernel with fp16 queries over fp16 pools
    q, kp, vp, bt, lens = odd_page_inputs(gen, cfg, F16)
    _, library = sdpa_over_live_keys(q, kp, vp, None, None, bt, lens)
    measured["paged_attention.decode.wmma.f16"] = check_k1_call(
        checks, timer, "paged_attention.decode.wmma[f16,page=12]", q, kp, vp, None, None, bt,
        lens, timed=True, library=library)
    del kp, vp
    # the append kernel
    for row_dt, pools in ((F16, (FP8, F16, torch.int8)), (F32, (F32, torch.int8, FP8))):
        for kv in pools:
            for phase in ("decode", "prefill"):
                r = check_paged_append(gen, timer, checks, kv, phase, cfg, row_dt,
                                       timed=kv == pools[0])
                if r is not None:
                    measured[f"paged_append.{phase}{LABEL_SUFFIX[row_dt]}"] = r
        measured[f"page32_append{LABEL_SUFFIX[row_dt]}"] = check_page32_append(
            gen, timer, checks, cfg, row_dt)
    # K3/K4 with fp16 activations: the decode and wgmma kernels timed over
    # int8 weights at m = 8 and 256, one layer's projections and the lm_head
    for m, kind in ((8, "decode"), (256, "wgmma")):
        measured[f"qmm.stacked.{kind}.f16"] = check_qmm(gen, timer, checks, torch.int8, m,
                                                        layer_shapes, True, x_dtype=F16)
        measured[f"qmm.single.{kind}.f16"] = check_qmm(gen, timer, checks, torch.int8, m,
                                                       [(d, cfg.vocab_size)], False, x_dtype=F16)
        for w_dt in (FP8, F16):
            for stacked in (True, False):
                check_qmm(gen, timer, checks, w_dt, m, few, stacked, timed=False, x_dtype=F16)
    for kind, m in (("bm16", 8), ("bm64", 256)):  # the WMMA kernels forced onto the layer
        measured[f"qmm.stacked.{kind}.f16"] = check_qmm(gen, timer, checks, torch.int8, m,
                                                        layer_shapes, True, kind=kind,
                                                        x_dtype=F16)
    # K3/K4 with f32 activations: unquantized f32 weights (the f32 engine's)
    # timed at m = 8 (and 256 beside it), the lm_head over int8 weights
    r8, r256 = (check_qmm(gen, timer, checks, F32, m, layer_shapes, True, x_dtype=F32)
                for m in (8, 256))
    measured["qmm.stacked.f32"] = dict(r8, other_shapes={"m256": r256})
    measured["qmm.single.f32"] = check_qmm(gen, timer, checks, torch.int8, 8,
                                           [(d, cfg.vocab_size)], False, x_dtype=F32)
    for w_dt in (torch.int8, FP8):
        for stacked in (True, False):
            for m in (8, 256):
                check_qmm(gen, timer, checks, w_dt, m, few, stacked, timed=False, x_dtype=F32)
    check_qmm(gen, timer, checks, F32, 19, [(200, 300)], False, timed=False, x_dtype=F32)
    return measured


def check_refusals(checks):
    """What still raises on the card: f64 in every kernel's wrapper (K1, the
    append kernel, K3/K4, K7, K8 and K9-K11), and mixed q / k dtypes in K7:
    a TypeError naming the kernel."""
    from xf_flash_attention_cutlass_tpu_torch.ops.flash_bwd import flash_bwd
    from xf_flash_attention_cutlass_tpu_torch.ops.flash_fwd import attention_probs, flash_fwd
    from xf_flash_attention_cutlass_tpu_torch.ops.paged import paged_attention
    from xf_flash_attention_cutlass_tpu_torch.ops.paged_append import paged_append
    from xf_flash_attention_cutlass_tpu_torch.quant.linear import quantized_matmul

    f64 = torch.float64
    x = torch.zeros((1, 4, 64, 64), dtype=f64, device="cuda")
    lse = torch.zeros((1, 4, 64), device="cuda")
    pool = torch.zeros((3, 2, 16, 64), dtype=f64, device="cuda")
    bt = torch.zeros((1, 2), dtype=torch.int32, device="cuda")
    lens = torch.ones(1, dtype=torch.int32, device="cuda")
    calls = dict(
        k1=lambda: paged_attention(torch.zeros((1, 1, 4, 64), dtype=f64, device="cuda"), pool,
                                   pool, bt, lens),
        append=lambda: paged_append(pool, pool, torch.zeros((1, 1, 2, 64), dtype=f64,
                                                             device="cuda"),
                                    torch.zeros((1, 1, 2, 64), dtype=f64, device="cuda"), bt,
                                    lens),
        qmm=lambda: quantized_matmul(torch.zeros((8, 64), dtype=f64, device="cuda"),
                                     torch.zeros((64, 64), dtype=torch.int8, device="cuda"),
                                     torch.ones(64, device="cuda")),
        k7=lambda: flash_fwd(x, x, x),
        k8=lambda: attention_probs(x, x, lse),
        k9_k11=lambda: flash_bwd(x, x, x, x, lse, x),
        k7_mixed=lambda: flash_fwd(x.float(), x.bfloat16(), x.bfloat16()))
    names = dict(k1="K1", append="K2/K5/K6", qmm="K3/K4", k7="K7", k8="K8", k9_k11="K9-K11",
                 k7_mixed="K7")
    for what, fn in calls.items():
        try:
            fn()
            msg = None
        except TypeError as e:
            msg = str(e)
        kind = "mixed" if what.endswith("_mixed") else "f64"
        checks.add(f"refusal.{kind}[{what.removesuffix('_mixed')}]",
                   msg is not None and names[what] in msg, message=msg)


def profile_decode_steps(eng, cfg, seed, n_steps=3):
    """Device time of decode-only steps of a chunked engine with 8 active
    requests (prompts of 200 tokens: one chunk each, admitted over as many
    steps as its prefill lanes need), from a profiler trace, with K1's and
    K3/K4's kernels by route."""
    rng = np.random.default_rng(seed + 2)
    n = eng.ecfg.max_batch
    for i in range(n):
        eng.add_request(2000 + i, rng.integers(0, cfg.vocab_size, 200).tolist(),
                        2 * n_steps + 2 * n)
    for _ in range(4 * n):
        if len(eng.active) == n and not any(eng._prefills) and not eng.queue:
            break
        eng.step()
    if len(eng.active) != n or any(eng._prefills):
        raise RuntimeError(f"decode profile: {len(eng.active)} of {n} requests decoding")
    groups = dict(K1_GROUPS, **K3_GROUPS, k1_f32="paged_f32_kernel", k3_f32="qmm_f32_kernel",
                  append=APPEND_KERNEL)
    prof = profiled(eng.step, n_steps, groups=groups)
    eng.run()
    return prof


def serving_dtype_paths(gen, cfg, checks, paths, seed, dtypes=(torch.float16, torch.float32)):
    """The fp16 and f32 serving paths at Llama-8B's full width and depth
    (random weights from the seed): each first the reference check of its
    cores (2 layers; the chunk, decode and bucketed prefill cores) against
    the CPU, then the 8 serving requests as a main path, its graphs against
    the eager step, and a profiled decode step. `serve_fp16`: fp16
    activations, INT8 weights, an FP8 page-256 cache, bucketed prefill (K7
    in fp16). `serve_f32`: unquantized f32 weights (32.1 GB), an f32 cache
    of 48 pages of 256, 256-token chunked prefill; then `serve_f32_bucketed`
    on the same params (serve_f32_bucketed: K7 in f32), its streams held to
    the chunked run's. Returns the report's rows."""
    from xf_flash_attention_cutlass_tpu_torch.models.llama import init_params, quantize_params
    from xf_flash_attention_cutlass_tpu_torch.serve.engine import DecodeEngine, EngineConfig

    out = {}
    for name, dtype in (("serve_fp16", F16), ("serve_f32", F32)):
        if dtype not in dtypes:
            continue
        t0 = time.perf_counter()
        if dtype == F16:
            params = quantize_params(init_params(gen, cfg, dtype=F16))
            ecfg = EngineConfig(kv_quant="fp8_e4m3", page_size=256, num_pages=256, max_seq=4096,
                                max_batch=8, prefill_chunk=None)
        else:
            params = init_params(gen, cfg, dtype=F32)
            ecfg = EngineConfig(page_size=256, num_pages=48, max_seq=4096, max_batch=8,
                                prefill_chunk=256)
        torch.cuda.synchronize()
        row = dict(init_s=time.perf_counter() - t0)
        row["reference_check_s"] = reference_check(
            params, cfg, checks, seed, name=f"engine_reference_{DT_TAG[dtype]}", dtype=dtype)
        eng = DecodeEngine(params, cfg, ecfg, dtype=dtype)
        eng.add_request(-1, list(range(300)), 2)  # warm-up request, not counted
        eng.run()
        torch.cuda.reset_peak_memory_stats()
        served, paths[name] = drive(name, lambda: serve(eng, cfg, seed))
        served["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
        served["launches"] = paths[name]
        check_graph_replay(eng, checks, name)
        prof = profile_decode(eng, cfg, seed) if dtype == F16 else profile_decode_steps(
            eng, cfg, seed)
        if prof is not None:
            prof["busy_share_of_p50_step"] = (prof["device_ms_per_step"]
                                              / served["decode_step_ms"]["p50"])
        row.update(serving=served, decode_profile=prof)
        print(json.dumps({name: row}), flush=True)
        out[name] = row
        chunked = {rid: list(eng.results[rid]) for rid in range(8)}
        del eng
        torch.cuda.empty_cache()
        checks.raise_on_failure(name)
        if dtype == F32:
            out["serve_f32_bucketed"] = serve_f32_bucketed(params, cfg, ecfg, checks, paths,
                                                           seed, chunked)
            print(json.dumps({"serve_f32_bucketed": out["serve_f32_bucketed"]}), flush=True)
            checks.raise_on_failure("serve_f32_bucketed")
        del params
    return out


def api_dtype_path(gen, cfg):
    """The api's K1 calls over fp16 and f32 caches (they raised on the card
    before): flash_attn_with_kvcache decoding b = 4 rows over a paged
    (num_blocks, 256, 8, 128) cache with one new token each appended, and
    flash_attn_varlen_func over the same cache with ragged queries of
    20-300 tokens (the chunk route for fp16, the f32 kernel for f32), each
    again with window (300, 0), softcap 30 and ALiBi (and a leftpad of 0-99
    for the decode: the options instantiations for fp16). A main path:
    returns each call's output beside CPU copies of its inputs (the caches
    as they were before the append) for check_api_dtype_outputs."""
    import xf_flash_attention_cutlass_tpu_torch as xfa
    from xf_flash_attention_cutlass_tpu_torch.utils.testing import alibi_slopes_ref

    h, h_k, d, page, per, b = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, 256, 4, 4
    slopes = torch.from_numpy(alibi_slopes_ref(h)).cuda()
    full = dict(window_size=(300, 0), softcap=30.0, alibi_slopes=slopes)
    cases = []
    for dt, opts in ((F16, {}), (F16, full), (F32, {}), (F32, full)):
        kc, vc = (torch.randn((b * per, page, h_k, d), generator=gen, device="cuda").to(dt)
                  for _ in range(2))
        bt = torch.randperm(b * per, generator=gen, device="cuda").int().reshape(b, per)
        seqlens = torch.randint(100, per * page - 1, (b,), generator=gen, device="cuda").int()
        q = torch.randn((b, 1, h, d), generator=gen, device="cuda").to(dt)
        kn, vn = (torch.randn((b, 1, h_k, d), generator=gen, device="cuda").to(dt)
                  for _ in range(2))
        dec_opts = dict(opts)
        if opts:
            dec_opts["cache_leftpad"] = torch.randint(0, 100, (b,), generator=gen,
                                                      device="cuda").int()
        before = [t.cpu() for t in (q, kc, vc, kn, vn, bt, seqlens)]
        out = xfa.flash_attn_with_kvcache(q, kc, vc, kn, vn, cache_seqlens=seqlens,
                                          block_table=bt, causal=True, **dec_opts)[0]
        cases.append(("kvcache_decode", dt, out.cpu(), before, (kc.cpu(), vc.cpu()),
                      {k: v.cpu() if torch.is_tensor(v) else v for k, v in dec_opts.items()}))
        lens_q = torch.randint(20, 301, (b,), generator=gen, device="cuda").tolist()
        cu_q = torch.tensor([0] + list(np.cumsum(lens_q)), dtype=torch.int32, device="cuda")
        used = torch.minimum(seqlens.long() + 1 + torch.tensor(lens_q, device="cuda"),
                             torch.tensor(per * page, device="cuda")).int()
        qv = torch.randn((int(cu_q[-1]), h, d), generator=gen, device="cuda").to(dt)
        out = xfa.flash_attn_varlen_func(qv, kc, vc, cu_q, None, max(lens_q), per * page,
                                         causal=True, block_table=bt, seqused_k=used, **opts)
        cases.append(("paged_varlen", dt, out.cpu(),
                      [t.cpu() for t in (qv, kc, vc, bt, cu_q, used)], max(lens_q),
                      {k: v.cpu() if torch.is_tensor(v) else v for k, v in opts.items()}))
        del kc, vc
    return cases


def check_api_dtype_outputs(checks, cases):
    """api_dtype_path's outputs against the plain versions on the CPU in the
    call's dtype and in f32 (f64 for f32) under the 2x rule; the caches the
    card appended to equal the CPU's bit for bit."""
    import xf_flash_attention_cutlass_tpu_torch as xfa
    from xf_flash_attention_cutlass_tpu_torch.ops.kvcache import attention_with_kvcache
    from xf_flash_attention_cutlass_tpu_torch.ops.varlen import flash_attn_varlen_paged

    for kind, dt, out, inp, extra, opts in cases:
        ref_dt = torch.float64 if dt == F32 else torch.float32
        up = [t.to(ref_dt) if t.is_floating_point() else t for t in inp]
        if kind == "kvcache_decode":
            q, kc, vc, kn, vn, bt, seqlens = inp
            kc_lp, vc_lp = kc.clone(), vc.clone()
            lp = xfa.flash_attn_with_kvcache(q, kc_lp, vc_lp, kn, vn, cache_seqlens=seqlens,
                                             block_table=bt, causal=True, **opts)[0]
            ref = attention_with_kvcache(up[0], up[1], up[2], up[3], up[4],
                                         cache_seqlens=seqlens, block_table=bt, causal=True,
                                         **opts)[0]
            same = torch.equal(extra[0], kc_lp) and torch.equal(extra[1], vc_lp)
        else:
            qv, kc, vc, bt, cu_q, used = inp
            lp = xfa.flash_attn_varlen_func(qv, kc, vc, cu_q, None, extra, kc.shape[0] * 256,
                                            causal=True, block_table=bt, seqused_k=used,
                                            **opts)
            vopts = dict(opts)
            if "window_size" in vopts:
                vopts["window"] = vopts.pop("window_size")
            ref, _ = flash_attn_varlen_paged(up[0], up[1], up[2], bt, cu_q, used,
                                             max_seqlen_q=extra, causal=True, **vopts)
            same = True
        tol = 2 * max_err(lp, ref) + 1e-5
        err, plain_err = max_err(out, ref), max_err(out, lp)
        checks.add(f"api.{kind}[{DT_TAG[dt]}{',options' if opts else ''}]",
                   err <= tol and plain_err <= tol and same and out.dtype == dt
                   and bool(torch.isfinite(out).all()),
                   max_abs_err=plain_err, tolerance=tol, err_vs_oracle=err, caches_equal=same)


# ---- phase 8: the dense flash family in f32 (K7, K8, K9-K11) -------------------------

# the 2x rule's absolute term for f32 results held to the f64 plain versions
F32_ATOL = 1e-5
# K7, K8 and K9-K11 in f32 off the paths' shapes: (name, b, h, h_k, sq, sk, d,
# options; flash_case's, and "alibi": the heads' alibi_slopes_ref slopes,
# "dropout": API_P under API_SEED), untimed
F32_FLASH_CASES = [
    ("unaligned_113x203", 2, 4, 2, 113, 203, 128, dict()),
    ("unaligned_causal_113x203", 2, 4, 2, 113, 203, 128, dict(causal=True)),
    ("d64", 2, 4, 2, 160, 160, 64, dict(causal=True)),
    ("d64_gqa_4_1_window", 1, 16, 4, 333, 333, 64, dict(window=(64, 64))),
    ("window", 1, 4, 2, 200, 200, 128, dict(window=(48, 16))),
    ("window_left_causal", 1, 8, 2, 384, 384, 128, dict(causal=True, window=(77, -1))),
    ("softcap", 1, 4, 2, 150, 190, 128, dict(causal=True, softcap=30.0)),
    ("segments", 2, 4, 2, 130, 130, 128, dict(causal=True, segments=True)),
    ("gqa_4_1", 1, 32, 8, 256, 256, 128, dict(causal=True)),
    ("kv_lens_empty_row", 2, 4, 2, 96, 96, 128, dict(causal=True, kv_lens=[50, 0])),
    ("sq1_causal_sk700", 1, 32, 8, 1, 700, 128, dict(causal=True)),
    ("ragged_300x1000_causal", 1, 8, 2, 300, 1000, 128, dict(causal=True)),
    ("alibi_dropout", 1, 8, 2, 300, 300, 128, dict(causal=True, alibi=True, dropout=True)),
    ("d64_all_options", 1, 8, 2, 200, 260, 64,
     dict(window=(100, 20), softcap=30.0, alibi=True, dropout=True)),
]


def f32_case(gen, b, h, h_k, sq, sk, d, opts):
    """flash_case's q, k, v, dO in f32 and its keywords, with the heads'
    ALiBi slopes ("alibi") and the api path's dropout ("dropout")."""
    from xf_flash_attention_cutlass_tpu_torch.utils.testing import alibi_slopes_ref

    opts = dict(opts)
    alibi, drop = opts.pop("alibi", False), opts.pop("dropout", False)
    tensors, kw = flash_case(gen, b, h, h_k, sq, sk, d, dict(opts, dtype=F32))
    if alibi:
        kw["alibi_slopes"] = torch.from_numpy(alibi_slopes_ref(h)).cuda()
    if drop:
        kw.update(dropout_p=API_P, dropout_seed=API_SEED)
    return tensors, kw


def f64(*tensors):
    return [t.double() for t in tensors]


def rule_2x(got, lp, ref):
    """(error against the f64 oracle, error against the f32 plain version,
    tolerance): the 2x rule, twice the f32 plain version's own error plus
    F32_ATOL."""
    return max_err(got, ref), max_err(got, lp), 2 * max_err(lp, ref) + F32_ATOL


def launched_once(label, fn):
    """fn's result, and whether it counted exactly one launch under label."""
    from xf_flash_attention_cutlass_tpu_torch import _build

    n0 = _build.LAUNCHES[label]
    out = fn()
    return out, _build.LAUNCHES[label] - n0 == 1


def check_f32_fwd(checks, name, q, k, v, kw):
    """K7 in f32 on given inputs against flash_fwd_ref in f64 (the oracle)
    and in f32 (the low-precision oracle) under the 2x rule, for O and for
    LSE; rows that see no key give O = 0 and LSE = -inf; one launch under
    flash_fwd.f32. Returns (error against the f32 plain version,
    tolerance)."""
    from xf_flash_attention_cutlass_tpu_torch.ops.flash_fwd import flash_fwd, flash_fwd_ref

    (o, lse), once = launched_once("flash_fwd.f32", lambda: flash_fwd(q, k, v, **kw))
    o32, l32 = flash_fwd_ref(q, k, v, **kw)
    o64, l64 = flash_fwd_ref(*f64(q, k, v), **kw)
    torch.cuda.synchronize()
    live = torch.isfinite(l64)
    err, plain_err, tol = rule_2x(o, o32, o64)
    lerr, lplain, ltol = rule_2x(lse[live], l32[live], l64[live])
    empty_ok = bool((o[~live] == 0).all() and torch.isneginf(lse[~live]).all())
    ok = (bool(torch.isfinite(o).all()) and o.dtype == F32 and empty_ok and once
          and max(err, plain_err) <= tol and max(lerr, lplain) <= ltol)
    checks.add(f"flash_fwd.f32.{name}", ok, max_abs_err=plain_err, tolerance=tol,
               err_vs_f64=err, lse_err=lplain, lse_err_vs_f64=lerr, lse_tolerance=ltol,
               empty_rows=int((~live).sum()), empty_rows_ok=empty_ok, launched=once)
    return plain_err, tol


def check_f32_bwd(checks, name, tensors, kw):
    """K9 + K10 (two-pass) and K11 (fused) in f32 against flash_bwd_ref in
    f64 (on the f64 forward's residuals) and in f32 (on the f32 plain
    forward's, which the kernels take too) under the 2x rule, for dq, dk and
    dv, each route launching under its f32 labels. Returns the residuals and
    the worst (error, tolerance) of each route."""
    from xf_flash_attention_cutlass_tpu_torch import _build
    from xf_flash_attention_cutlass_tpu_torch.ops.flash_bwd import flash_bwd, flash_bwd_ref
    from xf_flash_attention_cutlass_tpu_torch.ops.flash_fwd import flash_fwd_ref

    q, k, v, do = tensors
    o, lse = flash_fwd_ref(q, k, v, **kw)
    o64, l64 = flash_fwd_ref(*f64(q, k, v), **kw)
    g64 = flash_bwd_ref(*f64(q, k, v), o64, l64, do.double(), **kw)
    g32 = flash_bwd_ref(q, k, v, o, lse, do, **kw)
    del o64, l64
    worst = {}
    for route, fused, labels in (("two_pass", None, ("flash_bwd.dq.f32", "flash_bwd.dkv.f32")),
                                 ("fused", True, ("flash_bwd.fused.f32",))):
        n0 = [_build.LAUNCHES[x] for x in labels]
        got = flash_bwd(q, k, v, o, lse, do, fused=fused, **kw)
        torch.cuda.synchronize()
        once = [_build.LAUNCHES[x] - n for x, n in zip(labels, n0)] == [1] * len(labels)
        res = {g: rule_2x(x, x32, x64) for g, x, x32, x64 in zip(("dq", "dk", "dv"), got, g32,
                                                                   g64)}
        checks.add(f"flash_bwd.f32.{route}.{name}",
                   all(bool(torch.isfinite(x).all()) and x.dtype == F32 for x in got) and once
                   and all(max(e, pe) <= t for e, pe, t in res.values()),
                   **{f"{g}_err": r[1] for g, r in res.items()},
                   **{f"{g}_err_vs_f64": r[0] for g, r in res.items()},
                   **{f"{g}_tolerance": r[2] for g, r in res.items()}, launched=once)
        worst[route] = max(((r[1], r[2]) for r in res.values()), key=lambda t: t[0] / t[1])
    return o, lse, worst


def check_f32_probs(checks, name, q, k, lse, kw):
    """K8 in f32 against attention_probs_ref in f64 and in f32 on the same
    LSE under the 2x rule, its sign bits (the entries the dropout dropped)
    equal to the f32 plain version's everywhere. Returns (the plane, its
    error against the f32 plain version, the tolerance)."""
    from xf_flash_attention_cutlass_tpu_torch.ops.flash_fwd import (
        attention_probs,
        attention_probs_ref,
    )

    probs, once = launched_once("flash_probs.f32", lambda: attention_probs(q, k, lse, **kw))
    p32 = attention_probs_ref(q, k, lse, **kw)
    p64 = attention_probs_ref(*f64(q, k, lse), **kw)
    torch.cuda.synchronize()
    err, plain_err, tol = rule_2x(probs, p32, p64)
    del p64
    mismatches = int((torch.signbit(probs) != torch.signbit(p32)).sum())
    checks.add(f"flash_probs.f32[{name}]", bool(torch.isfinite(probs).all()) and once
               and max(err, plain_err) <= tol and mismatches == 0, max_abs_err=plain_err,
               tolerance=tol, err_vs_f64=err, sign_mismatches=mismatches, launched=once)
    return probs, plain_err, tol


def check_f32_dropout_mask(checks, name, q, k, lse, kw, probs):
    """The f32 plane's dropout signs against the bf16 kernel's plane on the
    same inputs rounded to bf16 (the same LSE): the sign bit of every entry
    equal, so both dtypes' kernels drop the same entries."""
    from xf_flash_attention_cutlass_tpu_torch.ops.flash_fwd import attention_probs

    p16 = attention_probs(q.bfloat16(), k.bfloat16(), lse, **kw)
    torch.cuda.synchronize()
    diff = int((torch.signbit(p16) != torch.signbit(probs)).sum())
    dropped = int(torch.signbit(probs).sum())
    checks.add(f"flash_probs.f32.dropout_mask_equals_bf16[{name}]", diff == 0 and dropped > 0,
               sign_mismatches=diff, dropped_entries=dropped)


def sdpa_yardstick(q, k, v, backward=False):
    """SDPA in q's dtype (causal, over the group-expanded heads; TF32 off):
    a callable of one forward (or, with backward, of the gradient of a
    forward already run), and the names of the kernels one call launches
    (the backend that ran; where kernel_names' traces all lost their spin,
    a note that says so)."""
    g = q.shape[1] // k.shape[1]
    if not backward:
        kx, vx = k.repeat_interleave(g, dim=1), v.repeat_interleave(g, dim=1)

        def fn():
            return F.scaled_dot_product_attention(q, kx, vx, is_causal=True)
    else:
        qx, kx, vx = (t.detach().requires_grad_(True) for t in (q, k, v))
        out = F.scaled_dot_product_attention(qx, kx.repeat_interleave(g, dim=1),
                                             vx.repeat_interleave(g, dim=1), is_causal=True)
        do = torch.randn_like(out)

        def fn():
            return torch.autograd.grad(out, (qx, kx, vx), do, retain_graph=True)
    try:  # the names only label the row: a trace that lost its spin names none
        names = kernel_names(fn)
    except RuntimeError as e:
        return fn, [f"not traced: {e}"]
    return fn, [n for n in names if "fmha" in n or "ttention" in n] or names[:4]


def time_f32_fwd(timer, q, k, v, kw, err, tol):
    """Times of K7 in f32, its plain version and SDPA in f32 (the backend
    named); the bound counts the visible pairs, 4 d operations each, at
    F32_FLOPS."""
    from xf_flash_attention_cutlass_tpu_torch.ops.flash_fwd import flash_fwd, flash_fwd_ref

    b, h, sq, d = q.shape
    o, lse = flash_fwd(q, k, v, **kw)
    library, names = sdpa_yardstick(q, k, v)
    ops = 4 * d * visible_pairs(b, h, sq, k.shape[2], kw)
    return dict(ms=timer.ms(lambda: flash_fwd(q, k, v, **kw)),
                device_ms=device_ms(lambda: flash_fwd(q, k, v, **kw), "flash_fwd_f32_kernel"),
                plain_ms=timer.ms(lambda: flash_fwd_ref(q, k, v, **kw), PLAIN_REPS),
                library_ms=timer.ms(library), library_kernels=names,
                bound=bound(nbytes(q, k, v, o, lse, kw.get("kv_lens")), ops, F32_FLOPS),
                err=err, tol=tol)


def check_f32_bwd_repeat(checks, tensors, kw, name, dq_tol):
    """K9 twice gives the same dQ bit for bit, K10 twice the same dK and dV;
    K11's dK and dV equal K10's bit for bit (the same tile products, summed
    in the same order); K11's dQ (the same tile parts, added by atomics in a
    changing order) agrees with K9's within the 2x rule's dq tolerance."""
    from xf_flash_attention_cutlass_tpu_torch.ops.flash_bwd import FlashBwdLaunch

    q, k, v, o, lse, do = tensors
    run = FlashBwdLaunch(q, k, v, o, lse, do, **bwd_launch_kw(kw, q.shape[-1]))
    (dk1, dv1), (dk2, dv2) = run.dkv(), run.dkv()
    dq9, dq9_again = run.dq(), run.dq()
    dq11, dk11, dv11 = run.fused()
    torch.cuda.synchronize()
    checks.add(f"flash_bwd.f32.dq_bit_reproducible[{name}]", bool(torch.equal(dq9, dq9_again)),
               max_abs_err=max_err(dq9, dq9_again), tolerance=0.0)
    checks.add(f"flash_bwd.f32.dkv_bit_reproducible[{name}]",
               bool(torch.equal(dk1, dk2) and torch.equal(dv1, dv2)),
               max_abs_err=max(max_err(dk1, dk2), max_err(dv1, dv2)), tolerance=0.0)
    checks.add(f"flash_bwd.f32.fused_dkv_equals_dkv[{name}]",
               bool(torch.equal(dk11, dk1) and torch.equal(dv11, dv1)),
               max_abs_err=max(max_err(dk11, dk1), max_err(dv11, dv1)), tolerance=0.0)
    err = max_err(dq11, dq9)
    checks.add(f"flash_bwd.f32.fused_dq_vs_dq[{name}]", err <= dq_tol, max_abs_err=err,
               tolerance=dq_tol, criterion="the 2x rule's dq tolerance")


def time_f32_bwd(timer, tensors, kw, worst):
    """Times of K9, K10 and K11 in f32 (each launched alone on prepared
    inputs), the plain backward and SDPA's backward in f32 (the backend
    named). Bounds at F32_FLOPS: 2 d operations per visible pair for each
    tile product, K9 three, K10 four, K11 five."""
    from xf_flash_attention_cutlass_tpu_torch.ops.flash_bwd import FlashBwdLaunch, flash_bwd_ref

    q, k, v, o, lse, do = tensors
    b, h, sq, d = q.shape
    run = FlashBwdLaunch(q, k, v, o, lse, do, **bwd_launch_kw(kw, d))
    pair_ops = 2 * d * visible_pairs(b, h, sq, k.shape[2], kw)
    plain_ms = timer.ms(lambda: flash_bwd_ref(q, k, v, o, lse, do, **kw), PLAIN_REPS)
    library, names = sdpa_yardstick(q, k, v, backward=True)
    library_ms = timer.ms(library)
    ins = nbytes(q, k, v, do, lse) + 4 * lse.numel()  # and Delta
    dq, (dk, dv) = run.dq(), run.dkv()
    out = {}
    for key, fn, n_prod, outs, route, kernel in (
            ("flash_bwd.dq.f32", "dq", 3, (dq,), "two_pass", "flash_bwd_dq_f32_kernel"),
            ("flash_bwd.dkv.f32", "dkv", 4, (dk, dv), "two_pass", "flash_bwd_dkv_f32_kernel"),
            ("flash_bwd.fused.f32", "fused", 5, (dq, dk, dv), "fused",
             "flash_bwd_dkv_f32_kernel")):
        out[key] = dict(ms=timer.ms(getattr(run, fn)),
                        device_ms=device_ms(getattr(run, fn), kernel),
                        plain_ms=plain_ms, library_ms=library_ms, library_kernels=names,
                        bound=bound(ins + nbytes(*outs), n_prod * pair_ops, F32_FLOPS),
                        err=worst[route][0], tol=worst[route][1])
    return out


def check_f32_views(gen, checks, cfg):
    """q, k, v and dO in f32 as the (b, s, h, d) views the model passes, at
    the training shape: K7, K9 and K10 read them as they are (no copy) and
    give the same bits as on contiguous copies, K11 the same dK, dV bits."""
    from xf_flash_attention_cutlass_tpu_torch.ops.flash_bwd import FlashBwdLaunch
    from xf_flash_attention_cutlass_tpu_torch.ops.flash_fwd import flash_fwd, flash_fwd_ref

    h, h_k, d, s = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, 1024
    views = [torch.randn((1, s, n, d), generator=gen, device="cuda").transpose(1, 2)
             for n in (h, h_k, h_k, h)]
    q, k, v, do = views
    kw = dict(causal=True)
    flat = [t.contiguous() for t in views]
    fwd_same = all(torch.equal(a, b) for a, b in zip(flash_fwd(q, k, v, **kw),
                                                     flash_fwd(*flat[:3], **kw)))
    o, lse = flash_fwd_ref(q, k, v, **kw)
    run = FlashBwdLaunch(q, k, v, o, lse, do, **bwd_launch_kw(kw, d))
    no_copy = all(a.data_ptr() == b.data_ptr() for a, b in zip((run.q, run.k, run.v, run.do),
                                                                 views))
    got = (run.dq(), *run.dkv(), *run.fused()[1:])
    run_c = FlashBwdLaunch(*flat[:3], o, lse, flat[3], **bwd_launch_kw(kw, d))
    want = (run_c.dq(), *run_c.dkv(), *run_c.fused()[1:])
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(got, want))
    checks.add("flash_f32.bshd_views_same_result", fwd_same and same and no_copy,
               forward_bit_equal=fwd_same, backward_bit_equal=same, no_copy=no_copy)


def check_flash_f32(gen, timer, checks, cfg, quick=False):
    """K7, K8 and K9-K11 in f32 (csrc/flash_f32.cu), each against its plain
    version in f64 and f32 under the 2x rule: K7 at the bucketed-prefill
    shape (bucket 1024, kv_len 716) timed, at `train_s1024` and s = 2048
    causal timed as its other shapes; K9, K10 and K11 at `train_s1024`
    timed, with the repeat and fused checks; K8 at (1, 32, 2048, 2048),
    causal with ALiBi and dropout 0.1, timed (and on device), its dropout
    signs equal to the bf16 kernel's; then F32_FLASH_CASES (K7, both
    backward routes and K8 where no kv_lens), the packed prompts with
    positions, segment ids and per-row ALiBi, and the (b, s, h, d) views;
    last K7 in fp16 at bucket 1024 timed (the serve_fp16 path's K7). With
    quick, F32_FLASH_CASES and the views only, untimed. Returns the timed
    rows by launch label."""
    from xf_flash_attention_cutlass_tpu_torch.ops.flash_fwd import flash_fwd, flash_fwd_ref

    def cases():
        for name, *shape, opts in F32_FLASH_CASES:
            (q, k, v, do), kw = f32_case(gen, *shape, opts)
            check_f32_fwd(checks, name, q, k, v, kw)
            check_f32_bwd(checks, name, (q, k, v, do), kw)
            if "kv_lens" not in kw:
                _, lse = flash_fwd_ref(q, k, v, **kw)
                probs, _, _ = check_f32_probs(checks, name, q, k, lse, kw)
                if "dropout_p" in kw:
                    check_f32_dropout_mask(checks, name, q, k, lse, kw, probs)
        tensors, kw = packed_case(gen, cfg, BWD_TILING_PACKED)
        q, k, v, do = (t.float() for t in tensors)
        check_f32_fwd(checks, "packed_positions_row_alibi", q, k, v, kw)
        check_f32_bwd(checks, "packed_positions_row_alibi", (q, k, v, do), kw)
        _, lse = flash_fwd_ref(q, k, v, **kw)
        check_f32_probs(checks, "packed_positions_row_alibi", q, k, lse, kw)
        check_f32_views(gen, checks, cfg)

    if quick:
        cases()
        return {}
    h, h_k, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    measured = {}
    (q, k, v, _), kw = f32_case(gen, 1, h, h_k, 1024, 1024, d, dict(causal=True, kv_lens=[716]))
    err, tol = check_f32_fwd(checks, "bucket1024_kv716", q, k, v, kw)
    measured["flash_fwd.f32"] = time_f32_fwd(timer, q, k, v, kw, err, tol)
    other = measured["flash_fwd.f32"]["other_shapes"] = {}
    for name, s in (("train_s1024", 1024), ("causal_s2048", 2048)):
        (q, k, v, do), kw = f32_case(gen, 1, h, h_k, s, s, d, dict(causal=True))
        err, tol = check_f32_fwd(checks, name, q, k, v, kw)
        other[name] = time_f32_fwd(timer, q, k, v, kw, err, tol)
    (q, k, v, do), kw = f32_case(gen, 1, h, h_k, 1024, 1024, d, dict(causal=True))
    o, lse, worst = check_f32_bwd(checks, "train_s1024", (q, k, v, do), kw)
    tensors = (q, k, v, o, lse, do)
    measured.update(time_f32_bwd(timer, tensors, kw, worst))
    dq_tol = max(c["dq_tolerance"] for c in checks.cases
                 if c["case"] in ("flash_bwd.f32.two_pass.train_s1024",
                                  "flash_bwd.f32.fused.train_s1024"))
    check_f32_bwd_repeat(checks, tensors, kw, "train_s1024", dq_tol)
    del tensors, o
    # K8 at the api path's shape and options
    (q, k, v, _), kw = f32_case(gen, 1, h, h_k, API_S, API_S, d,
                                dict(causal=True, alibi=True, dropout=True))
    _, lse = flash_fwd(q, k, v, **kw)
    probs, err, tol = check_f32_probs(checks, "api_s2048_alibi_dropout", q, k, lse, kw)
    check_f32_dropout_mask(checks, "api_s2048_alibi_dropout", q, k, lse, kw, probs)
    from xf_flash_attention_cutlass_tpu_torch.ops.flash_fwd import (
        attention_probs,
        attention_probs_ref,
    )

    pairs = visible_pairs(1, h, API_S, API_S, dict(causal=True))
    measured["flash_probs.f32"] = dict(
        ms=timer.ms(lambda: attention_probs(q, k, lse, **kw)),
        device_ms=device_ms(lambda: attention_probs(q, k, lse, **kw), "flash_probs_f32_kernel"),
        plain_ms=timer.ms(lambda: attention_probs_ref(q, k, lse, **kw), PLAIN_REPS),
        library_ms=None, bound=bound(nbytes(q, k, lse, probs), 2 * d * pairs, F32_FLOPS),
        err=err, tol=tol)
    del probs, q, k, v
    torch.cuda.empty_cache()
    cases()
    # K7 in fp16 at bucket 1024: the serve_fp16 path's K7, beside SDPA in fp16
    x, kw, err, tol = check_flash_fwd(gen, checks, "f16.bucket1024_kv716", 1, h, h_k, 1024,
                                      1024, d, dict(causal=True, kv_lens=[716], dtype=F16))
    r = time_flash_fwd(timer, *x, kw, err, tol)
    r.pop("ms_general")
    measured["flash_fwd.f16"] = r
    return measured


def train_f32(gen, cfg, seed, checks, paths):
    """f32 training at Llama-8B widths cut to 8 layers (train(): three SGD
    steps on K7/K9/K10 in f32, one on K11, then the profiled step, the loss
    falling at each; rate 0.002: at train()'s 0.005 the fifth step's loss
    rose on an H100, 10.02 -> 10.94), a main path;
    then the gradient of a 2-layer copy (plain_grad_check: f32 against the
    plain versions in f64, the oracle, and in f32). Returns the report's
    row."""
    c8 = dataclasses.replace(cfg, n_layers=8)
    torch.cuda.reset_peak_memory_stats()
    (ok, row), paths["train_f32"] = drive("train_f32",
                                          lambda: train(gen, c8, seed, lr=0.002, dtype=F32))
    checks.add("train_f32.loss_falls", ok, losses=row["losses"])
    plain_grad_check(gen, cfg, seed, checks, "train_f32.grad_2layer_vs_f64_plain", F32,
                     torch.float64)
    row["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return row


def api_f32_path(gen, cfg):
    """The api's dense calls in f32 at Llama-8B attention width (32 q / 8 kv
    heads, d = 128), through the wrappers a user calls: flash_attn_func at
    2048 tokens, causal, ALiBi, dropout 0.1, return_attn_probs, and the
    gradient of sum(out * w); packed flash_attn_varlen_func over the 8
    serving prompts, causal, per-sequence ALiBi slopes, and its gradient;
    flash_attn_func at d = 64 (b = 2, 300 tokens, 8 / 2 heads, causal) and
    its gradient. A main path: returns each call's inputs and outputs for
    check_api_f32_outputs."""
    import xf_flash_attention_cutlass_tpu_torch as xfa
    from xf_flash_attention_cutlass_tpu_torch.utils.testing import alibi_slopes_ref

    h, h_k, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def randn(*sh):
        return torch.randn(sh, generator=gen, device="cuda")

    out = {}
    xs = [randn(1, API_S, n, d).requires_grad_(True) for n in (h, h_k, h_k)]
    w = randn(1, API_S, h, d)
    slopes = torch.from_numpy(alibi_slopes_ref(h)).cuda()
    o, lse, probs = xfa.flash_attn_func(*xs, dropout_p=API_P, causal=True, alibi_slopes=slopes,
                                        return_attn_probs=True, dropout_seed=API_SEED)
    grads = torch.autograd.grad((o * w).sum(), xs)
    out["dense"] = dict(x=[t.detach() for t in xs], w=w, o=o.detach(), lse=lse, probs=probs,
                        grads=grads, kw=dict(causal=True, alibi_slopes=slopes, dropout_p=API_P,
                                             dropout_seed=API_SEED))
    lens = serving_prompt_lens(0)
    T = sum(lens)
    cu = torch.tensor(np.cumsum([0] + lens), dtype=torch.int32, device="cuda")
    xs = [randn(T, n, d).requires_grad_(True) for n in (h, h_k, h_k)]
    w = randn(T, h, d)
    slopes_b = torch.rand((len(lens), h), generator=gen, device="cuda") * 0.1
    o = xfa.flash_attn_varlen_func(*xs, cu, cu, max(lens), max(lens), causal=True,
                                   alibi_slopes=slopes_b)
    grads = torch.autograd.grad((o * w).sum(), xs)
    out["packed"] = dict(x=[t.detach() for t in xs], w=w, o=o.detach(), grads=grads, cu=cu,
                         slopes=slopes_b)
    xs = [randn(2, 300, n, 64).requires_grad_(True) for n in (8, 2, 2)]
    w = randn(2, 300, 8, 64)
    o = xfa.flash_attn_func(*xs, causal=True)
    grads = torch.autograd.grad((o * w).sum(), xs)
    out["d64"] = dict(x=[t.detach() for t in xs], w=w, o=o.detach(), grads=grads,
                      kw=dict(causal=True))
    return out


def check_api_f32_outputs(checks, res):
    """api_f32_path's outputs against the plain versions on the card, in
    f64 (the oracle) and in f32, under the 2x rule: O, the dense call's LSE
    and plane (its signs equal to the f32 plain plane's), and the gradients
    (flash_bwd_ref on each run's own residuals). The packed call is held to
    the plain versions over the packed tokens with the segment ids,
    positions and per-row slopes the varlen entry builds."""
    from xf_flash_attention_cutlass_tpu_torch.ops.flash_bwd import flash_bwd_ref
    from xf_flash_attention_cutlass_tpu_torch.ops.flash_fwd import (
        attention_probs_ref,
        flash_fwd_ref,
    )
    from xf_flash_attention_cutlass_tpu_torch.ops.varlen import (
        _packed_positions,
        _row_slopes_from_segments,
    )

    def bhsd(t):  # (b, s, h, d), or packed (T, h, d), as the ops take it
        return t[None].transpose(1, 2) if t.dim() == 3 else t.transpose(1, 2)

    for name, r in res.items():
        kw = r.get("kw")
        if name == "packed":
            T = r["o"].shape[0]
            qseg, kseg, qpos, kpos = _packed_positions(r["cu"], r["cu"], T, T)
            kw = dict(causal=True, q_segment_ids=qseg[None], kv_segment_ids=kseg[None],
                      q_positions=qpos[None], kv_positions=kpos[None],
                      alibi_row_slopes=_row_slopes_from_segments(r["slopes"], qseg))
        q, k, v, w = (bhsd(t) for t in (*r["x"], r["w"]))
        plain = {}
        for dt in (F32, torch.float64):
            xq, xk, xv, xw = (t.to(dt) for t in (q, k, v, w))
            o, lse = flash_fwd_ref(xq, xk, xv, **kw)
            plain[dt] = dict(o=o, lse=lse, grads=flash_bwd_ref(xq, xk, xv, o, lse, xw, **kw))
            if "probs" in r:
                plain[dt]["probs"] = attention_probs_ref(xq, xk, lse, **kw)
        got = dict(o=bhsd(r["o"]), grads=[bhsd(g) for g in r["grads"]])
        res_2x = {"o": rule_2x(got["o"], plain[F32]["o"], plain[torch.float64]["o"])}
        for g, x, x32, x64 in zip(("dq", "dk", "dv"), got["grads"], plain[F32]["grads"],
                                  plain[torch.float64]["grads"]):
            res_2x[g] = rule_2x(x, x32, x64)
        extra = {}
        if "probs" in r:
            live = torch.isfinite(plain[torch.float64]["lse"])
            res_2x["lse"] = rule_2x(r["lse"][live], plain[F32]["lse"][live],
                                    plain[torch.float64]["lse"][live])
            res_2x["probs"] = rule_2x(r["probs"], plain[F32]["probs"],
                                      plain[torch.float64]["probs"])
            extra["sign_mismatches"] = int(
                (torch.signbit(r["probs"]) != torch.signbit(plain[F32]["probs"])).sum())
        del plain
        finite = all(bool(torch.isfinite(t).all()) for t in (got["o"], *got["grads"]))
        checks.add(f"api_f32.{name}", finite and extra.get("sign_mismatches", 0) == 0
                   and all(max(e, pe) <= t for e, pe, t in res_2x.values()),
                   **{f"{n}_err": x[1] for n, x in res_2x.items()},
                   **{f"{n}_err_vs_f64": x[0] for n, x in res_2x.items()},
                   **{f"{n}_tolerance": x[2] for n, x in res_2x.items()}, **extra)


def serve_f32_bucketed(params, cfg, ecfg, checks, paths, seed, chunked):
    """Llama-8B in f32 with bucketed prefill (buckets 256-2048: K7 in f32)
    on serve_f32's params and cache geometry, the 8 serving requests as a
    main path, its graphs against the eager step and a profiled decode step;
    its greedy streams against the chunked run's (`chunked`): equal, or
    else both runs served again with their logits recorded and held to the
    tie rule. Returns the report's row."""
    from xf_flash_attention_cutlass_tpu_torch.serve.engine import DecodeEngine

    becfg = dataclasses.replace(ecfg, prefill_chunk=None)
    eng = DecodeEngine(params, cfg, becfg, dtype=F32)
    eng.add_request(-1, list(range(300)), 2)  # warm-up request, not counted
    eng.run()
    torch.cuda.reset_peak_memory_stats()
    served, paths["serve_f32_bucketed"] = drive("serve_f32_bucketed",
                                                lambda: serve(eng, cfg, seed))
    served["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    served["launches"] = paths["serve_f32_bucketed"]
    check_graph_replay(eng, checks, "serve_f32_bucketed")
    streams = {rid: list(eng.results[rid]) for rid in chunked}
    prof = profile_decode_steps(eng, cfg, seed)
    if prof is not None:
        prof["busy_share_of_p50_step"] = (prof["device_ms_per_step"]
                                          / served["decode_step_ms"]["p50"])
    exact = sum(streams[rid] == chunked[rid] for rid in chunked)
    if exact == len(chunked):
        checks.add("serve_f32_bucketed.streams_equal_chunked", True, exact=exact,
                   requests=len(chunked))
    else:  # serve both again, recording the logits each token came from
        rng = np.random.default_rng(seed)
        lens = rng.integers(200, 1501, 8)
        prompts = {100 + i: rng.integers(0, cfg.vocab_size, int(n)).tolist()
                   for i, n in enumerate(lens)}
        runs = []
        for e in (DecodeEngine(params, cfg, ecfg, dtype=F32), eng):
            streams_r, logits, _, _ = serve_recorded(e, prompts, 32)
            runs.append((streams_r, logits))
        tie_rule(checks, "serve_f32_bucketed.vs_chunked", runs[0], runs[1])
    del eng
    torch.cuda.empty_cache()
    return dict(serving=served, decode_profile=prof, streams_equal_chunked=exact)


def f32_flash_phase(gen, timer, checks, cfg, paths, seed):
    """Phase 8's kernels and refusal-free paths: the f32 kernel checks
    (check_flash_f32), f32 training (train_f32) and the api's f32 calls
    (api_f32, a main path, checked after). Returns the report's rows."""
    measured = check_flash_f32(gen, timer, checks, cfg)
    print(json.dumps({"flash_f32_kernels": measured}), flush=True)
    checks.raise_on_failure("f32 flash kernels")
    torch.cuda.empty_cache()
    training = train_f32(gen, cfg, seed, checks, paths)
    print(json.dumps({"train_f32": training}), flush=True)
    checks.raise_on_failure("f32 training")
    res, paths["api_f32"] = drive("api_f32", lambda: api_f32_path(gen, cfg))
    check_api_f32_outputs(checks, res)
    del res
    checks.raise_on_failure("api f32")
    torch.cuda.empty_cache()
    return measured, training


def dtypes_phase_alone(out_dir=None):
    """Build everything, then run this slice's phase alone (the kernel checks
    and refusals, the api's fp16 and f32 calls, then the two serving paths);
    for bring-up (dtypes_bringup.py --stages phase). Returns the exit code."""
    from xf_flash_attention_cutlass_tpu_torch import _build
    from xf_flash_attention_cutlass_tpu_torch.models.llama import LlamaConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _build.build_all()
    phase_s = dict(build=time.perf_counter() - t0)
    print(json.dumps({"build_s": phase_s["build"]}), flush=True)
    cfg = LlamaConfig.llama8b()
    gen = torch.Generator(device="cuda").manual_seed(0)
    checks, paths, report = Checks(), {}, {}
    t0 = time.perf_counter()
    report["dtype_kernels"] = check_dtype_kernels(gen, Timer(), checks, cfg)
    check_refusals(checks)
    cases, paths["api_dtypes"] = drive("api_dtypes", lambda: api_dtype_path(gen, cfg))
    check_api_dtype_outputs(checks, cases)
    phase_s["dtype_kernels"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ok = True
    try:
        report["serving_dtypes"] = serving_dtype_paths(gen, cfg, checks, paths, 0)
    except RuntimeError as e:
        print(f"serving_dtypes: {e}", flush=True)
        ok = False
    phase_s["serving_dtypes"] = time.perf_counter() - t0
    bad = [c["case"] for c in checks.cases if not c["ok"]]
    print(json.dumps({"phase_s": phase_s, "failed": bad, "n_checks": len(checks.cases)}),
          flush=True)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "dtypes_phase.json"), "w") as f:
            json.dump(dict(report, checks=checks.cases, phase_s=phase_s), f, indent=1,
                      default=str)
    return 0 if ok and not bad else 1



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


# mangled template arguments: the activations' 16-bit type (bf16 or f16), and
# the weights' or pool's (int8 a, fp8, or a substitution S.._ that repeats the
# activations' type: an unscaled stack or an unquantized pool)
_T16 = {"13__nv_bfloat16": "bf16", "6__half": "f16"}
_TW = "(a|9fp8e4m3_t|13__nv_bfloat16|6__half|S\\d*_)"


def _weight_tag(mangled_arg, t16):
    return {"a": "int8", "9fp8e4m3_t": "fp8"}.get(mangled_arg, t16)


def qmm_instantiation(mangled):
    """'wgmma128_int8', 'decode_n8_fp8', 'bm16_fp8', 'bm64_bf16', ... (the
    kernel, its tile width or height or its tokens, the weight type) for a
    mangled qmm kernel name of bf16 activations, the same with 'f16_' after
    the kernel for fp16 activations ('wgmma128_f16_int8'), 'f32_bm16_int8'
    for the f32 kernel, else None (the split-K reduction)."""
    t16 = "(13__nv_bfloat16|6__half)"
    m = re.search(r"qmm_f32_kernelI(f|a|9fp8e4m3_t)Li(\d+)E", mangled)
    if m is not None:
        return f"f32_bm{m.group(2)}_{_weight_tag(m.group(1), 'f32')}"
    m = re.search(rf"qmm_(wgmma|decode)_kernelI{t16}{_TW}Li(\d+)E", mangled)
    if m is not None:
        kind, t, tw, tile = m.group(1), _T16[m.group(2)], m.group(3), int(m.group(4))
    else:
        m = re.search(rf"qmm_(kernel)I{t16}Li(\d+)E{_TW}E", mangled)
        if m is None:
            return None
        kind, t, tile, tw = m.group(1), _T16[m.group(2)], int(m.group(3)), m.group(4)
    dtype = _weight_tag(tw, t)
    pre = "" if t == "bf16" else "f16_"
    if kind == "decode":
        return f"decode_n{8 * tile}_{pre}{dtype}"
    return f"{'wgmma' if kind == 'wgmma' else 'bm'}{tile}_{pre}{dtype}"


def build_usage(libs, names, instantiation):
    """ptxas_usage of each library in `names` (a source and its fp16 variant,
    _build.VARIANTS) with the SASS counts of each instantiation added."""
    inst = {}
    for name in (n for n in names if n in libs):
        inst.update(ptxas_usage(name, instantiation))
        for mangled, counts in sass_by_function(libs[name]).items():
            label = instantiation(mangled)
            if label is not None:
                inst.setdefault(label, {}).update(counts)
    return inst


def qmm_build_report(checks, libs):
    """Registers and spill bytes of every qmm instantiation (build/qmm.log)
    and the SASS counts of each. Checks that each wgmma instantiation holds
    HGMMA and UTMALDG and no HMMA, that each of the six decode ones holds
    HMMA (mma.sync) and UTMALDG, no HGMMA and no spill, and that the WMMA
    ones keep their HMMA; and that the occupancy calculator gives every
    decode instantiation the resident blocks an SM its split plan counts."""
    from xf_flash_attention_cutlass_tpu_torch.quant import linear

    inst = build_usage(libs, ("qmm", "qmm_f16"), qmm_instantiation)
    print(json.dumps({"qmm_build": inst}), flush=True)
    wgmma = {n: r for n, r in inst.items() if n.startswith("wgmma")}
    decode = {n: r for n, r in inst.items() if n.startswith("decode")}
    wmma = {n: r for n, r in inst.items() if n.startswith("bm")}
    f32 = {n: r for n, r in inst.items() if n.startswith("f32")}
    checks.add("qmm.decode_sass_mma_sync_tma_no_wgmma",
               len(decode) == 12 and all(r.get("HMMA", 0) > 0 and r.get("UTMALDG", 0) > 0
                                         and r.get("HGMMA", 1) == 0 for r in decode.values()),
               sass={n: {op: r.get(op) for op in SASS_OPS} for n, r in decode.items()})
    checks.add("qmm.decode_no_spills",
               len(decode) == 12 and all(r.get("spill_bytes") == 0 for r in decode.values()),
               registers={n: r.get("registers") for n, r in decode.items()},
               spill_bytes={n: r.get("spill_bytes") for n, r in decode.items()})
    occ = {f"{DT_TAG[xt]}/{str(dt).split('.')[-1]}_n{rows}":
           linear.qmm_decode_blocks_per_sm(dt, rows, xt)
           for xt in (torch.bfloat16, torch.float16)
           for dt in (torch.int8, torch.float8_e4m3fn, xt) for rows in (8, 16)}
    checks.add("qmm.decode_resident_blocks",
               all(v == linear.QMM_DECODE_BLOCKS_PER_SM for v in occ.values()),
               blocks_per_sm=occ, expected=linear.QMM_DECODE_BLOCKS_PER_SM)
    checks.add("qmm.wgmma_sass_wgmma_tma_no_mma_sync",
               len(wgmma) == 12 and all(r.get("HGMMA", 0) > 0 and r.get("UTMALDG", 0) > 0
                                        and r.get("HMMA", 1) == 0 for r in wgmma.values()),
               sass={n: {op: r.get(op) for op in SASS_OPS} for n, r in wgmma.items()})
    checks.add("qmm.wmma_sass_keeps_mma_sync",
               len(wmma) == 12 and all(r.get("HMMA", 0) > 0 for r in wmma.values()),
               hmma={n: r.get("HMMA") for n, r in wmma.items()})
    # the f32 kernel: FMA only (no tensor-core instruction); spills reported
    checks.add("qmm.f32_no_tensor_cores",
               len(f32) == 6 and all(r.get("HMMA", 1) == 0 and r.get("HGMMA", 1) == 0
                                     for r in f32.values()),
               registers={n: r.get("registers") for n, r in f32.items()},
               spill_bytes={n: r.get("spill_bytes") for n, r in f32.items()})
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


_F32_NAME = re.compile(r"flash_(fwd|probs|bwd_dq|bwd_dkv)_f32_kernelILi(\d+)E((?:Lb[01]E)*)")


def f32_instantiation(mangled):
    """'fwd_d128', 'probs_d64', 'dq_d128', 'dkv_d128', 'fused_d64', ... for a
    mangled kernel name of csrc/flash_f32.cu ('fwd_d128_tail', 'dkv_d64_tail',
    ... for the instantiations of head dims below their rung), else None."""
    m = _F32_NAME.search(mangled)
    if m is None:
        return None
    bools = re.findall(r"Lb([01])E", m.group(3))
    tail = "_tail" if bools and bools[-1] == "1" else ""
    kind = {"fwd": "fwd", "probs": "probs", "bwd_dq": "dq"}.get(m.group(1))
    kind = kind or ("fused" if bools[0] == "1" else "dkv")
    return f"{kind}_d{m.group(2)}{tail}"


# the kernels of flash_f32.cu at d = 64 and 128 (not tail), gated on spills
F32_GATED = tuple(f"{k}_d{d}" for k in ("fwd", "probs", "dq", "dkv", "fused") for d in (64, 128))
K7_F32_GATED = F32_GATED[:2]  # K7 f32's


def flash_f32_build_report(checks):
    """Registers and spill bytes of every kernel of csrc/flash_f32.cu
    (build/flash_f32.log): forty instantiations (K7, K8, K9, K10 and K11 at
    four rungs, each also for head dims below the rung), the ten at d = 64
    and 128 spilling nothing; the others reported by wide_build_report (K7)
    and bwd_wide_build_report (K8-K11)."""
    inst = ptxas_usage("flash_f32", f32_instantiation)
    print(json.dumps({"flash_f32_build": inst}), flush=True)
    gated = {n: r for n, r in inst.items() if n in F32_GATED}
    checks.add("flash_f32.no_spills",
               len(inst) == 40 and len(gated) == 10
               and all(r.get("spill_bytes") == 0 for r in gated.values()),
               spill_bytes={n: r.get("spill_bytes") for n, r in inst.items()},
               registers={n: r.get("registers") for n, r in inst.items()})
    return inst


_BWD_NAME = re.compile(r"flash_bwd_(dkv|dq)(?:_wide)?_kernelI(\w+?)Li(\d+)E(?:Lb([01])E)?Lb([01])E")


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


_K1_NAME = re.compile(r"paged_(wgmma|attention|decode)_kernelI(13__nv_bfloat16|6__half)"
                      + _TW + r"Li(\d+)E(?:Li(\d+)E)?(?:Lb([01])E)?")
_K1_COMBINE = re.compile(r"paged_combine_kernelI(13__nv_bfloat16|6__half|f)Li(\d+)E")
_K1_F32 = re.compile(r"paged_f32_kernelI(f|a|9fp8e4m3_t)Li(\d+)E")


def k1_instantiation(mangled):
    """'wgmma_fp8_d128' for a mangled Hopper K1 chunk kernel name of bf16
    queries, 'decode_int8_d64_n8' for a decode one (n: its 8 or 16 query
    rows), each with '_options' for its options instantiation;
    'wmma_int8_d64_rt32_options' or '..._plain' for a WMMA one; the same with
    'f16_' after the kernel for fp16 queries ('decode_f16_fp8_d128_n8');
    'combine_d128' (bf16 O), 'combine_f16_d128' or 'combine_f32_d128' for
    the combine kernel; 'f32_fp8_d128' for the f32 kernel; else None."""
    m = _K1_COMBINE.search(mangled)
    if m is not None:
        out = {"13__nv_bfloat16": "", "6__half": "f16_", "f": "f32_"}[m.group(1)]
        return f"combine_{out}d{m.group(2)}"
    m = _K1_F32.search(mangled)
    if m is not None:
        return f"f32_{_weight_tag(m.group(1), 'f32')}_d{m.group(2)}"
    m = _K1_NAME.search(mangled)
    if m is None:
        return None
    kind, t = m.group(1), _T16[m.group(2)]
    name = (f"{'wmma' if kind == 'attention' else kind}_{'' if t == 'bf16' else 'f16_'}"
            f"{_weight_tag(m.group(3), t)}_d{m.group(4)}")
    if kind == "decode":
        name += f"_n{8 * int(m.group(5))}"
    elif kind == "attention":
        return name + f"_rt{m.group(5)}_{'options' if m.group(6) == '1' else 'plain'}"
    return name + ("_options" if m.group(6) == "1" else "")


def paged_build_report(checks, libs):
    """Registers and spill bytes of every K1 instantiation
    (build/paged_attention.log) and the SASS counts of each. Checks that the
    24 Hopper chunk instantiations (bf16 and fp16 queries, option-free and
    with the options) hold HGMMA and UTMALDG, no HMMA and no spill, that the
    48 decode ones hold HMMA (mma.sync) and UTMALDG and spill nothing, that
    the six combine ones (bf16, fp16, f32 O) spill nothing, that the 48 WMMA
    ones (every one still reached: pages of no whole TMA box, with and
    without the options) keep their HMMA, that the six f32 ones hold no
    tensor-core instruction, and that every decode instantiation keeps the
    two resident blocks an SM its split plan counts."""
    inst = build_usage(libs, ("paged_attention", "paged_attention_f16"), k1_instantiation)
    print(json.dumps({"paged_build": inst}), flush=True)
    kinds = {k: {n: r for n, r in inst.items() if n.startswith(k)}
             for k in ("wgmma", "wmma", "decode", "combine", "f32")}
    wgmma, decode = kinds["wgmma"], kinds["decode"]
    checks.add("paged_attention.wgmma_sass_wgmma_tma_no_mma_sync",
               len(wgmma) == 24 and all(r.get("HGMMA", 0) > 0 and r.get("UTMALDG", 0) > 0
                                       and r.get("HMMA", 1) == 0 for r in wgmma.values()),
               sass={n: {op: r.get(op) for op in SASS_OPS} for n, r in wgmma.items()})
    checks.add("paged_attention.wgmma_no_spills",
               len(wgmma) == 24 and all(r.get("spill_bytes") == 0 for r in wgmma.values()),
               spill_bytes={n: r.get("spill_bytes") for n, r in wgmma.items()})
    checks.add("paged_attention.decode_sass_mma_sync_tma",
               len(decode) == 48 and all(r.get("HMMA", 0) > 0 and r.get("UTMALDG", 0) > 0
                                         for r in decode.values()),
               sass={n: {op: r.get(op) for op in SASS_OPS} for n, r in decode.items()})
    spills = {n: r.get("spill_bytes") for k in ("decode", "combine") for n, r in kinds[k].items()}
    checks.add("paged_attention.decode_and_combine_no_spills",
               len(spills) == 54 and all(b == 0 for b in spills.values()), spill_bytes=spills)
    checks.add("paged_attention.wmma_sass_keeps_mma_sync",
               len(kinds["wmma"]) == 48 and all(r.get("HMMA", 0) > 0
                                                for r in kinds["wmma"].values()),
               hmma={n: r.get("HMMA") for n, r in kinds["wmma"].items()})
    checks.add("paged_attention.f32_no_tensor_cores",
               len(kinds["f32"]) == 6 and all(r.get("HMMA", 1) == 0 and r.get("HGMMA", 1) == 0
                                              for r in kinds["f32"].values()),
               registers={n: r.get("registers") for n, r in kinds["f32"].items()},
               spill_bytes={n: r.get("spill_bytes") for n, r in kinds["f32"].items()})
    # the decode route's split heuristic counts DECODE_BLOCKS blocks an SM
    # at each rung: the occupancy calculator must agree for every
    # instantiation (the rungs 192 and 256: head_dims_phase)
    from xf_flash_attention_cutlass_tpu_torch.ops import paged

    occ = {f"{DT_TAG[qt]}/{str(dt).split('.')[-1]}_d{d}_n{n}{'_options' if o else ''}":
           paged.decode_blocks_per_sm(dt, d, n, o, qt)
           for qt in (torch.bfloat16, torch.float16)
           for dt in (torch.float8_e4m3fn, torch.int8, qt) for d in (64, 128)
           for n in (8, 16) for o in (False, True)}
    # (a parent tree measured by this harness may predate the rungs' table)
    want = getattr(paged, "DECODE_BLOCKS", {}).get(128) or paged.DECODE_BLOCKS_PER_SM
    checks.add("paged_attention.decode_resident_blocks", all(v == want for v in occ.values()),
               blocks_per_sm=occ, expected=want)
    return inst


# ---- phase 9: K1 and K7 at every head dim; Phi-3-mini widths served ----------

# the head dims of the JAX package's K7 tests (tests/test_flash_fwd.py) and
# its serving tests' 16; 59 and 111 (and 40 over int8 / fp8 pools) take the
# padded copy; the options at HEAD_DIM_TIMED, where the rows are also timed
HEAD_DIMS = (16, 32, 40, 59, 64, 80, 96, 111, 128, 160, 192, 224, 256)
HEAD_DIM_TIMED = (96, 256)
BF16, I8 = torch.bfloat16, torch.int8
# K1's (query, pool) dtypes: bf16 and fp16 over their own, fp8 and int8; f32 over f32
K1_WIDTH_DTYPES = ((BF16, BF16), (BF16, FP8), (BF16, I8), (F16, F16), (F16, FP8), (F16, I8),
                   (F32, F32))


def phi3_config():
    """Phi-3-mini-4k-instruct's published widths (config.json of
    huggingface.co/microsoft/Phi-3-mini-4k-instruct): hidden 3072,
    intermediate 8192, 32 layers, 32 query and 32 KV heads (head dim 96),
    vocab 32064, rope_theta 10000, rms_norm_eps 1e-5, 4096 positions. Its
    blocks are the Llama stack's (RMSNorm, SwiGLU, NeoX rotary, no biases);
    its fused qkv_proj and gate_up_proj are the stack's separate
    projections concatenated. Weights are random from the seed."""
    from xf_flash_attention_cutlass_tpu_torch.models.llama import LlamaConfig

    return LlamaConfig(vocab_size=32064, dim=3072, n_layers=32, n_heads=32, n_kv_heads=32,
                       ffn_dim=8192, max_seq_len=4096, rope_base=10000.0, rms_eps=1e-5)


def launches_of(fn):
    """fn's result and the launches it added: by label, and by label, head
    dim and rung (_build.HEAD_DIM_LAUNCHES)."""
    from collections import Counter

    from xf_flash_attention_cutlass_tpu_torch import _build

    l0, h0 = Counter(_build.LAUNCHES), Counter(_build.HEAD_DIM_LAUNCHES)
    out = fn()
    return (out, dict(Counter(_build.LAUNCHES) - l0),
            dict(Counter(_build.HEAD_DIM_LAUNCHES) - h0))


def k1_width_case(gen, d, q_dtype, kv_dtype, rows, page=16, b=3):
    """K1's inputs at head dim d: two layers of pools of 40 pages (+ trash)
    with 2 KV heads, 8 query heads (GQA 4:1), block tables of 24 pages, b
    entries whose kv_lens are drawn below the table's keys, the last one
    inactive. rows "decode": sq = 1 (4 rows a KV head: the decode kernel);
    "chunk": sq = 64 (256 rows: the Hopper chunk kernel)."""
    h, h_k, n_pages, max_pages = 8, 2, 40, 24
    sq = 1 if rows == "decode" else 64
    kp, vp, ks, vs = kv_pools(gen, kv_dtype, 2, n_pages, h_k, page, d)
    bt = torch.stack([torch.randperm(n_pages, generator=gen, device="cuda")[:max_pages]
                      for _ in range(b)]).int()
    lens = torch.randint(sq, max_pages * page + 1, (b,), generator=gen, device="cuda").int()
    lens[-1] = 0
    bt[-1] = n_pages
    q = torch.randn((b, sq, h, d), generator=gen, device="cuda").to(q_dtype)
    return q, kp, vp, ks, vs, bt, lens


def check_k1_width(checks, name, q, kp, vp, ks, vs, bt, lens, timer=None, library=None,
                   **opts):
    """check_k1_call (the 2x rule against the plain version and the oracle,
    one launch under the route's label), and that the call launched that
    route's kernel at the head dim and rung mapped_head_dim and
    head_dim_rung name (the pad copy where the head dim run is not d), and
    the combine at that head dim where it split. Timed with a timer."""
    from xf_flash_attention_cutlass_tpu_torch import _build
    from xf_flash_attention_cutlass_tpu_torch.ops import paged

    d = q.shape[-1]
    route, splits = paged.paged_plan(q.shape, kp.shape, kp.dtype, bt.shape[1], **opts,
                                     q_dtype=q.dtype)
    full = dict(causal=True, window=(-1, -1), softcap=0.0, alibi_slopes=None, cache_leftpad=None)
    full.update(opts)
    label = paged.route_label(route, q.shape[1] * (q.shape[2] // kp.shape[-3]),
                              paged.has_options(**full), q.dtype)
    dm = paged.mapped_head_dim(d, q.dtype, kp.dtype)
    rung = paged.head_dim_rung(dm)
    want = {_build.head_dim_key(label, dm, rung): 1}
    if splits > 1 and route != "wmma":
        comb = "paged_attention.combine" + _build.LABEL_SUFFIX[q.dtype]
        want[_build.head_dim_key(comb, dm, dm if dm in (64, 128) else 0)] = 1
    row, by_label, by_dim = launches_of(lambda: check_k1_call(
        checks, None, name, q, kp, vp, ks, vs, bt, lens, layer_idx=1, **opts))
    if timer is not None:  # after the counted call: the kernel, its plain version, the library
        sc = {} if ks is None else dict(k_scales=ks, v_scales=vs)
        sc1 = {} if ks is None else dict(k_scales=ks[1], v_scales=vs[1])
        case = checks.cases[-1]
        row = dict(
            ms=timer.ms(lambda: paged.paged_attention(q, kp, vp, bt, lens, layer_idx=1, **sc,
                                                      **opts)),
            plain_ms=timer.ms(lambda: paged.paged_attention_ref(
                q, kp[1], vp[1], bt, lens, num_splits=splits, **sc1, **opts), PLAIN_REPS),
            library_ms=None if library is None else timer.ms(library),
            bound=k1_bound(q, kp, ks, bt, lens, **opts), err=case["max_abs_err"],
            tol=case["tolerance"], route=route, splits=splits, head_dim=dm, rung=rung)
    pads = by_label.get("paged_attention.pad_copy", 0)
    checks.add(f"{name}.route_and_rung", by_dim == want and pads == int(dm != d),
               launched=by_dim, expected=want, route=route, splits=splits, head_dim_run=dm,
               rung=rung, pad_copies=pads)
    return row


def check_k7_width(checks, name, q, k, v, kw):
    """K7 (the Hopper kernel, or the f32 kernel for f32 inputs) under the 2x
    rule (check_flash_fwd_inputs, check_f32_fwd), and that it launched once
    at the head dim and rung flash_head_dim and flash_rung name (the pad copy
    where that head dim is not d). Returns (error, tolerance)."""
    from xf_flash_attention_cutlass_tpu_torch import _build
    from xf_flash_attention_cutlass_tpu_torch.ops.flash_fwd import (
        flash_head_dim,
        flash_label,
        flash_rung,
    )

    d = q.shape[-1]
    dm = flash_head_dim(d, q.dtype)
    want = {_build.head_dim_key(flash_label("flash_fwd", q.dtype), dm, flash_rung(dm)): 1}
    if q.dtype == F32:
        res, by_label, by_dim = launches_of(lambda: check_f32_fwd(checks, name, q, k, v, kw))
    else:
        res, by_label, by_dim = launches_of(
            lambda: check_flash_fwd_inputs(checks, name, q, k, v, kw))
    pads = by_label.get("flash_fwd.pad_copy", 0)
    checks.add(f"flash_fwd.{'f32.' if q.dtype == F32 else ''}{name}.rung",
               by_dim == want and pads == int(dm != d), launched=by_dim, expected=want,
               head_dim_run=dm, pad_copies=pads)
    return res


def k1_option_sets(b, h):
    """The options held at HEAD_DIM_TIMED on each Hopper K1 kernel: softcap,
    ALiBi and leftpad together; a window start; a right window (non-causal)."""
    from xf_flash_attention_cutlass_tpu_torch.utils.testing import alibi_slopes_ref

    slopes = torch.from_numpy(alibi_slopes_ref(h)).cuda()
    leftpad = torch.tensor([5, 17, 0][:b], dtype=torch.int32, device="cuda")
    return dict(softcap_alibi_leftpad=dict(softcap=20.0, alibi_slopes=slopes,
                                           cache_leftpad=leftpad),
                window=dict(window=(48, 0)),
                right_window=dict(causal=False, window=(-1, 8)))


def check_head_dims(gen, checks):
    """K1 and K7 at every width of HEAD_DIMS, untimed, small shapes: K1 on the
    decode kernel (4 rows a KV head) and the Hopper chunk kernel (256 rows)
    with every (query, pool) dtype pair of K1_WIDTH_DTYPES (f32 on the f32
    kernel), on the WMMA kernel over pages of 12 keys (decode rows, bf16
    over fp8; chunk rows, fp16 over int8), the combine on every split run;
    K7 (bf16 and fp16) and its f32 kernel, causal and not. At
    HEAD_DIM_TIMED the options on each Hopper kernel: K1's (k1_option_sets)
    and K7's kv_lens and segments, window, softcap and ALiBi."""
    from xf_flash_attention_cutlass_tpu_torch.utils.testing import alibi_slopes_ref

    for d in HEAD_DIMS:
        for q_dt, kv_dt in K1_WIDTH_DTYPES:
            for rows in ("decode", "chunk"):
                case = k1_width_case(gen, d, q_dt, kv_dt, rows)
                check_k1_width(checks, f"head_dims.k1[{rows},{DT_TAG[q_dt]}/{DT_TAG[kv_dt]},"
                               f"d={d}]", *case)
        for rows, q_dt, kv_dt in (("decode", BF16, FP8), ("chunk", F16, I8)):
            case = k1_width_case(gen, d, q_dt, kv_dt, rows, page=12)
            check_k1_width(checks, f"head_dims.k1_odd_page[{rows},{DT_TAG[q_dt]}/"
                           f"{DT_TAG[kv_dt]},d={d}]", *case)
        for dt in (BF16, F16, F32):
            for causal in (True, False):
                (q, k, v, _), kw = flash_case(gen, 2, 4, 2, 100, 130, d,
                                              dict(causal=causal, dtype=dt))
                check_k7_width(checks, f"head_dims[{DT_TAG[dt]},d={d},causal={causal}]",
                               q, k, v, kw)
    for d in HEAD_DIM_TIMED:
        for rows in ("decode", "chunk"):
            q, kp, vp, ks, vs, bt, lens = k1_width_case(gen, d, BF16, FP8, rows)
            for oname, opts in k1_option_sets(q.shape[0], q.shape[2]).items():
                check_k1_width(checks, f"head_dims.k1_options[{rows},{oname},d={d}]", q, kp, vp,
                               ks, vs, bt, lens, **opts)
        for oname, opts in (("kv_lens_segments", dict(kv_lens=[100, 77], segments=True)),
                            ("window_softcap_alibi", dict(window=(32, 0), softcap=20.0))):
            for dt in (BF16, F16):
                (q, k, v, _), kw = flash_case(gen, 2, 4, 2, 100, 130, d,
                                              dict(causal=True, dtype=dt, **opts))
                if oname == "window_softcap_alibi":
                    kw["alibi_slopes"] = torch.from_numpy(alibi_slopes_ref(4)).cuda()
                check_k7_width(checks, f"head_dims_options[{DT_TAG[dt]},{oname},d={d}]",
                               q, k, v, kw)


def head_dim_rows(gen, timer, checks):
    """The timed rows at HEAD_DIM_TIMED, at Phi-3-mini geometry (32 query and
    32 KV heads) with the head dim set: K1 decode (b = 8 over kv_lens of
    200-1533 in FP8 page-256 pools; SDPA over the live keys beside it), K1's
    chunk (sq = 256 over 1024 keys), the combine (f32 partials of that
    decode shape at 4 splits, the Llama-8B decode's count), K1 f32 decode
    (f32 pools), K7 at bucket 1024 (causal, SDPA beside it) and K7 f32. Each
    row: ms, plain_ms, bound, library_ms, err, tol. Returns {name: row}."""
    out = {}
    for d in HEAD_DIM_TIMED:
        cfg = dataclasses.replace(phi3_config(), head_dim_override=d)
        for phase, q_dt, kv_dt, label in (
                ("decode", BF16, FP8, "paged_attention.decode"),
                ("prefill", BF16, FP8, "paged_attention.prefill.wgmma"),
                ("decode", F32, F32, "paged_attention.decode.f32")):
            q, kp, vp, ks, vs, bt, lens = paged_inputs(gen, kv_dt, phase, cfg, q_dtype=q_dt)
            ksl, vsl = (None, None) if ks is None else (ks[1], vs[1])
            t_live, library = sdpa_over_live_keys(q, kp[1], vp[1], ksl, vsl, bt, lens)
            row = check_k1_width(checks, f"head_dims.timed[{label},d={d}]", q, kp, vp, ks, vs,
                                 bt, lens, timer=timer, library=library)
            row["library_keys"] = t_live
            out[f"{label}@d{d}"] = row
            del q, kp, vp, ks, vs
        out[f"paged_attention.combine@d{d}"] = check_paged_combine(
            gen, timer, checks, cfg, 4, tag=f"d={d},")
        (q, k, v, _), kw = flash_case(gen, 1, 32, 32, 1024, 1024, d, dict(causal=True))
        err, tol = check_k7_width(checks, f"head_dims.timed[bucket1024,d={d}]", q, k, v, kw)
        out[f"flash_fwd@d{d}"] = time_flash_fwd(timer, q, k, v, kw, err, tol)
        (q, k, v, _), kw = f32_case(gen, 1, 32, 32, 1024, 1024, d, dict(causal=True))
        err, tol = check_k7_width(checks, f"head_dims.timed[bucket1024,d={d}]", q, k, v, kw)
        out[f"flash_fwd.f32@d{d}"] = time_f32_fwd(timer, q, k, v, kw, err, tol)
        del q, k, v
        torch.cuda.empty_cache()
    return out


def head_dims_phase(gen, timer, checks, quick=False):
    """Phase 9's kernel part: the decode kernel's and the f32 kernel's
    resident blocks at every rung against the split plan's tables, the
    widths (check_head_dims) and, unless quick, the timed rows."""
    from xf_flash_attention_cutlass_tpu_torch.ops import paged

    occ = {f"{DT_TAG[qt]}/{DT_TAG[dt]}_D{r}_n{n}{'_options' if o else ''}":
           paged.decode_blocks_per_sm(dt, r, n, o, qt)
           for qt in (BF16, F16) for dt in (FP8, I8, qt) for r in (192, 256)
           for n in (8, 16) for o in (False, True)}
    checks.add("head_dims.decode_resident_blocks",
               all(v == paged.DECODE_BLOCKS[int(k.split("_D")[1].split("_")[0])]
                   for k, v in occ.items()), blocks_per_sm=occ, expected=paged.DECODE_BLOCKS)
    f32_occ = {(dt, r): paged.f32_blocks_per_sm(dt, r)
               for dt in (F32, FP8, I8) for r in paged.HEAD_DIM_RUNGS}
    checks.add("head_dims.f32_resident_blocks",
               all(v == paged.F32_BLOCKS[k] for k, v in f32_occ.items()),
               blocks_per_sm={f"{DT_TAG[dt]}_D{r}": v for (dt, r), v in f32_occ.items()},
               expected={f"{DT_TAG[dt]}_D{r}": v for (dt, r), v in paged.F32_BLOCKS.items()})
    check_head_dims(gen, checks)
    return {} if quick else head_dim_rows(gen, timer, checks)


def wide_build_report(checks, libs):
    """Registers and spill bytes of the head-dim rungs 192 and 256 (K1's wide
    libraries, K7's, K7 f32's), with the SASS counts of each: reported, not
    gated on spills. Checks that every K1 Hopper chunk and K7 instantiation
    there holds HGMMA and UTMALDG and no HMMA, every decode one HMMA and
    UTMALDG, every WMMA one HMMA, the f32 ones no tensor-core instruction,
    and the counts: 24 chunk, 48 decode, 48 WMMA and 6 f32 kernels of K1,
    8 of K7, 6 of K7 f32 (the rungs 192 and 256, and head dims below each
    rung)."""
    k1 = build_usage(libs, ("paged_attention_wide", "paged_attention_f16_wide"),
                     k1_instantiation)
    k7 = ptxas_usage("flash_fwd_wide", k7_instantiation)
    k7_sass = {k7_instantiation(n): c for n, c in sass_by_function(libs["flash_fwd_wide"]).items()
               if k7_instantiation(n)}
    f32 = {n: r for n, r in ptxas_usage("flash_f32", f32_instantiation).items()
           if n.startswith("fwd_") and n not in K7_F32_GATED}
    report = dict(k1=k1, k7=dict(instantiations=k7, sass=k7_sass), k7_f32=f32)
    print(json.dumps({"wide_build": report}), flush=True)
    kinds = {k: {n: r for n, r in k1.items() if n.startswith(k)}
             for k in ("wgmma", "wmma", "decode", "f32")}
    hopper = list(kinds["wgmma"].values()) + list(k7_sass.values())
    checks.add("head_dims.wide_sass",
               len(kinds["wgmma"]) == 24 and len(k7_sass) == 8
               and all(r.get("HGMMA", 0) > 0 and r.get("UTMALDG", 0) > 0 and r.get("HMMA", 1) == 0
                       for r in hopper)
               and len(kinds["decode"]) == 48
               and all(r.get("HMMA", 0) > 0 and r.get("UTMALDG", 0) > 0
                       for r in kinds["decode"].values())
               and len(kinds["wmma"]) == 48
               and all(r.get("HMMA", 0) > 0 for r in kinds["wmma"].values())
               and len(kinds["f32"]) == 6
               and all(r.get("HMMA", 1) == 0 and r.get("HGMMA", 1) == 0
                       for r in kinds["f32"].values()) and len(f32) == 6,
               counts={k: len(v) for k, v in kinds.items()}, k7=len(k7_sass), k7_f32=len(f32))
    return report


def bwd_wide_build_report(checks, libs):
    """Registers, spill bytes and SASS counts of K8 and K9-K11 at the
    head-dim rungs 192 and 256 (flash_probs_wide, flash_bwd_wide: K10/K11 the
    split by tensor) and of their f32 kernels other than d = 64 and 128
    (flash_f32: the rungs 192 and 256, and the head dims below each rung):
    reported, not gated on spills. Checks that each of the 8 K8, 8 K9 and 16
    K10/K11 instantiations holds HGMMA and UTMALDG and no HMMA, and the 24
    f32 ones no tensor-core instruction."""
    def by_function(lib, instantiation, keep=lambda n: True):
        return {instantiation(n): c for n, c in sass_by_function(libs[lib]).items()
                if instantiation(n) and keep(instantiation(n))}

    k8 = dict(instantiations=ptxas_usage("flash_probs_wide", probs_instantiation),
              sass=by_function("flash_probs_wide", probs_instantiation))
    bwd = dict(instantiations=ptxas_usage("flash_bwd_wide", bwd_instantiation),
               sass=by_function("flash_bwd_wide", bwd_instantiation))
    f32_keep = lambda n: not n.startswith("fwd_") and n not in F32_GATED  # noqa: E731
    f32 = dict(instantiations={n: r for n, r in ptxas_usage("flash_f32", f32_instantiation).items()
                               if f32_keep(n)},
               sass=by_function("flash_f32", f32_instantiation, f32_keep))
    report = dict(k8=k8, k9_k11=bwd, f32=f32)
    print(json.dumps({"bwd_wide_build": report}), flush=True)
    hopper = list(k8["sass"].values()) + list(bwd["sass"].values())
    checks.add("head_dims.bwd_wide_sass",
               len(k8["sass"]) == 8 and len(bwd["sass"]) == 24
               and all(r.get("HGMMA", 0) > 0 and r.get("UTMALDG", 0) > 0 and r.get("HMMA", 1) == 0
                       for r in hopper)
               and len(f32["sass"]) == 24
               and all(r.get("HMMA", 1) == 0 and r.get("HGMMA", 1) == 0
                       for r in f32["sass"].values()),
               counts=dict(k8=len(k8["sass"]), k9_k11=len(bwd["sass"]), f32=len(f32["sass"])))
    return report


def check_head_dim_96(checks, path, kernels):
    """Check that every launch of a main path counted by head dim was at
    d = 96 on the rung 128 (the any-width combine: rung 0) and that each of
    `kernels` launched there. Returns the path's launches by head dim."""
    dims = HEAD_DIM_PATHS[path]
    bad = [k for k in dims if not (k.endswith("@d96/D128") or k.endswith("@d96/D0"))]
    missing = [k for k in kernels if not any(x.startswith(f"{k}@d96/") for x in dims)]
    checks.add(f"{path}.head_dim_96", not bad and not missing, off_width=bad, missing=missing,
               launches=dims)
    return dims


def serve_phi3(gen, checks, paths, seed):
    """Phi-3-mini-4k widths (phi3_config: head dim 96, 32 layers) with random
    INT8 weights from the seed and an FP8 page-256 cache: the reference
    check of its cores (2 layers) against the CPU, then the 8 serving
    requests twice as main paths, `serve_phi3_chunked` (256-token chunks)
    and `serve_phi3_bucketed` (K7 at d = 96), each with its graphs held to
    the eager step, and a profiled decode step of the bucketed engine. Every
    K1 and K7 launch of both paths must be at head dim 96 on the rung 128.
    The streams: a chunked engine at 256-token chunks held to one at 512
    under the tie rule; the bucketed engine's against the chunked one's
    printed, not gated (its prompt pass reads the prompt's own K/V, the
    chunked one the FP8 cache). Returns the report's row."""
    from xf_flash_attention_cutlass_tpu_torch import _build
    from xf_flash_attention_cutlass_tpu_torch.models.llama import init_params, quantize_params
    from xf_flash_attention_cutlass_tpu_torch.serve.engine import DecodeEngine, EngineConfig

    cfg = phi3_config()
    t0 = time.perf_counter()
    params = quantize_params(init_params(gen, cfg))
    torch.cuda.synchronize()
    row = dict(config=dataclasses.asdict(cfg), head_dim=cfg.head_dim,
               init_s=time.perf_counter() - t0,
               weight_gb=sum(t.numel() * t.element_size() for t in _leaves(params)) / 1e9)
    row["reference_check_s"] = reference_check(params, cfg, checks, seed, name="phi3_reference")
    checks.raise_on_failure("phi3 reference check")
    ecfg = EngineConfig(kv_quant="fp8_e4m3", page_size=256, num_pages=256, max_seq=4096,
                        max_batch=8, prefill_chunk=256)
    runs = {}
    for name, e in (("serve_phi3_chunked", ecfg),
                    ("serve_phi3_bucketed", dataclasses.replace(ecfg, prefill_chunk=None))):
        eng = DecodeEngine(params, cfg, e)
        eng.add_request(-1, list(range(300)), 2)  # warm-up request, not counted
        eng.run()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        served, paths[name] = drive(name, lambda: serve(eng, cfg, seed))
        served["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
        served["launches"] = paths[name]
        want = [k for k in PATHS[name] if k.startswith(("paged_attention", "flash_fwd"))]
        served["head_dim_launches"] = check_head_dim_96(checks, name, want)
        check_graph_replay(eng, checks, name)
        runs[name] = {rid: list(eng.results[rid]) for rid in range(8)}
        if name == "serve_phi3_bucketed":
            prof = profile_decode(eng, cfg, seed)
            if prof is not None:
                prof["busy_share_of_p50_step"] = (prof["device_ms_per_step"]
                                                  / served["decode_step_ms"]["p50"])
            served["decode_profile"] = prof
        row[name] = served
        print(json.dumps({name: served}), flush=True)
        del eng
        torch.cuda.empty_cache()
        checks.raise_on_failure(name)
    # the streams: the chunked run against a second chunked engine at
    # 512-token chunks (the same FP8 cache bytes, another tiling of the
    # prefill's products) under the tie rule, gated; the bucketed run
    # against the chunked run measured only, as serve_moe's: its prompt pass
    # attends over the prompt's own bf16 K/V where the chunked one reads
    # the FP8 cache, which moves the logits by more than TIE_DELTA
    chunked, bucketed = runs["serve_phi3_chunked"], runs["serve_phi3_bucketed"]
    row["streams_equal"] = sum(bucketed[rid] == chunked[rid] for rid in chunked)
    rng = np.random.default_rng(seed)
    lens = rng.integers(200, 1501, 8)
    prompts = {100 + i: rng.integers(0, cfg.vocab_size, int(n)).tolist()
               for i, n in enumerate(lens)}
    rec = {}
    for name, e in (("chunk256", ecfg), ("chunk512", dataclasses.replace(ecfg, prefill_chunk=512)),
                    ("bucketed", dataclasses.replace(ecfg, prefill_chunk=None))):
        eng = DecodeEngine(params, cfg, e)
        streams, logits, _, _ = serve_recorded(eng, prompts, 32)
        rec[name] = (streams, logits)
        del eng
        torch.cuda.empty_cache()
    row["tie_rule"] = tie_rule(checks, "serve_phi3.chunk512_vs_chunk256", rec["chunk256"],
                               rec["chunk512"])
    row["measured_bucketed_vs_chunked"] = tie_rule(
        Checks(), "serve_phi3.measured.bucketed_vs_chunked", rec["chunk256"], rec["bucketed"])
    del params
    torch.cuda.empty_cache()
    checks.raise_on_failure("serve_phi3")
    _build.HEAD_DIM_LAUNCHES.clear()
    return row


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


# ---- phase 10: K8 and K9-K11 at every head dim, Phi-3-mini trained --------------

BWD_HEAD_DIMS = tuple(d for d in HEAD_DIMS if d not in (64, 128))  # beside phases 3 and 8
_BWD = ("flash_bwd.dq", "flash_bwd.dkv", "flash_bwd.fused")


def check_width_launches(checks, name, fn, d, dtype, kernels, pad_label, n_pads):
    """fn's result, and a check that it launched each of `kernels` once at
    the head dim and rung flash_head_dim and flash_rung name for d, with
    n_pads padded copies (pad_label) where that head dim is not d, none
    elsewhere."""
    from xf_flash_attention_cutlass_tpu_torch import _build
    from xf_flash_attention_cutlass_tpu_torch.ops.flash_fwd import (
        flash_head_dim,
        flash_label,
        flash_rung,
    )

    dm = flash_head_dim(d, dtype)
    want = {_build.head_dim_key(flash_label(k, dtype), dm, flash_rung(dm)): 1 for k in kernels}
    res, by_label, by_dim = launches_of(fn)
    pads = by_label.get(pad_label, 0)
    checks.add(f"{name}.rung", by_dim == want and pads == (n_pads if dm != d else 0),
               launched=by_dim, expected=want, head_dim_run=dm, pad_copies=pads)
    return res


def bwd_width(checks, tag, tensors, kw, oracle_kw=None):
    """K9 + K10 and K11 (16-bit) on given inputs under the 3x rule
    (check_flash_bwd_inputs), each launch at its head dim and rung. Returns
    the residuals and the worst (error, tolerance) of each route."""
    d, dt = tensors[0].shape[-1], tensors[0].dtype
    return check_width_launches(
        checks, f"flash_bwd.head_dims[{tag}]",
        lambda: check_flash_bwd_inputs(checks, f"head_dims[{tag}]", tensors, kw, oracle_kw), d,
        dt, _BWD, "flash_bwd.pad_copy", 2)


def probs_width(checks, tag, q, k, lse, kw):
    """K8 on given inputs (check_probs, or check_f32_probs for f32), its
    launch at its head dim and rung. K8 takes no kv_lens: where kw has them,
    the LSE is that of the forward without them (it depends on q and k
    alone)."""
    from xf_flash_attention_cutlass_tpu_torch.ops.flash_fwd import flash_fwd_ref

    d, dt = q.shape[-1], q.dtype
    kwp = {n: x for n, x in kw.items() if n != "kv_lens"}
    if "kv_lens" in kw:
        lse = flash_fwd_ref(q, k, k, **kwp)[1]
    check = check_f32_probs if dt == F32 else check_probs
    return check_width_launches(
        checks, f"flash_probs.head_dims[{tag}]",
        lambda: check(checks, f"head_dims[{tag}]", q, k, lse, kwp), d, dt, ("flash_probs",),
        "flash_probs.pad_copy", 1)


def f32_bwd_width(checks, tag, tensors, kw):
    """K9 + K10 and K11 in f32 (check_f32_bwd: the 2x rule against the f64
    plain version), each launch at its head dim and rung."""
    return check_width_launches(
        checks, f"flash_bwd.f32.head_dims[{tag}]",
        lambda: check_f32_bwd(checks, f"head_dims[{tag}]", tensors, kw), tensors[0].shape[-1],
        F32, _BWD, "flash_bwd.pad_copy", 2)


def bwd_option_cases(gen, d, dtype):
    """The options held at HEAD_DIM_TIMED: (name, (q, k, v, dO), kw,
    oracle_kw): ALiBi with dropout (the oracle given the port's mask), a
    window from both sides with softcap, segment ids with kv_lens, and the
    packed case's explicit positions, segments and per-row ALiBi."""
    from xf_flash_attention_cutlass_tpu_torch.ops.flash_fwd import dropout_keep_mask
    from xf_flash_attention_cutlass_tpu_torch.utils.testing import alibi_slopes_ref

    b, h, h_k, s = 1, 8, 2, 200
    tensors, _ = flash_case(gen, b, h, h_k, s, s, d, dict(dtype=dtype))
    slopes = torch.from_numpy(alibi_slopes_ref(h)).cuda()
    kw = dict(causal=True, alibi_slopes=slopes, dropout_p=API_P, dropout_seed=API_SEED)
    okw = dict(causal=True, alibi_slopes=slopes, dropout_p=API_P,
               dropout_mask=dropout_keep_mask(API_SEED, API_P, b, h, s, s, "cuda"))
    yield "alibi_dropout", tensors, kw, okw
    tensors, kw = flash_case(gen, b, h, h_k, s, 230, d,
                             dict(window=(48, 16), softcap=20.0, dtype=dtype))
    yield "window_softcap", tensors, kw, None
    tensors, kw = flash_case(gen, 2, h, h_k, 150, 150, d,
                             dict(causal=True, segments=True, kv_lens=[150, 97], dtype=dtype))
    yield "segments_kv_lens", tensors, kw, None
    if dtype != F32:
        cfg = dataclasses.replace(phi3_config(), n_heads=4, n_kv_heads=2, head_dim_override=d)
        tensors, kw = packed_case(gen, cfg, BWD_TILING_PACKED)
        yield "positions_row_alibi", [t.to(dtype) for t in tensors], kw, None


def check_bwd_head_dims(gen, checks):
    """K8, K9, K10 and K11 at every width of BWD_HEAD_DIMS, untimed, small
    shapes (b = 2, 4 query heads over 2 KV heads, 100 rows over 130 keys;
    GQA 4:1 at HEAD_DIM_TIMED): bf16 and fp16 on the Hopper kernels, causal
    and not, K9-K11 under the 3x rule, K8 entry by entry against its plain
    version; f32 on the f32 kernels under the 2x rule against the f64 plain
    versions; every launch at the head dim and rung the route functions
    name, padded copies at 59 and 111 only. At HEAD_DIM_TIMED: K9 and K10
    twice bit for bit and K11's dK/dV equal to K10's (check_flash_bwd_repeat),
    and the options (bwd_option_cases) on K8-K11 in bf16, fp16 and f32."""
    for d in BWD_HEAD_DIMS:
        h, h_k = (8, 2) if d in HEAD_DIM_TIMED else (4, 2)
        for dt in (BF16, F16, F32):
            for causal in (True, False):
                tag = f"{DT_TAG[dt]},d={d},causal={causal}"
                if dt == F32:
                    tensors, kw = f32_case(gen, 2, h, h_k, 100, 130, d, dict(causal=causal))
                    o, lse, _ = f32_bwd_width(checks, tag, tensors, kw)
                else:
                    tensors, kw = flash_case(gen, 2, h, h_k, 100, 130, d,
                                             dict(causal=causal, dtype=dt))
                    o, lse, _ = bwd_width(checks, tag, tensors, kw)
                probs_width(checks, tag, tensors[0], tensors[1], lse, kw)
                if d in HEAD_DIM_TIMED and causal and dt == BF16:
                    q, k, v, do = tensors
                    check_flash_bwd_repeat(checks, (q, k, v, o, lse, do), kw, f"d={d}")
    for d in HEAD_DIM_TIMED:
        for dt in (BF16, F16, F32):
            for oname, tensors, kw, okw in bwd_option_cases(gen, d, dt):
                tag = f"{DT_TAG[dt]},{oname},d={d}"
                if dt == F32:
                    o, lse, _ = f32_bwd_width(checks, tag, tensors, kw)
                else:
                    o, lse, _ = bwd_width(checks, tag, tensors, kw, okw)
                probs_width(checks, tag, tensors[0], tensors[1], lse, kw)


def bwd_head_dim_rows(gen, timer, checks):
    """The timed rows at HEAD_DIM_TIMED, at Phi-3-mini geometry (32 query and
    32 KV heads) with the head dim set: K9, K10 and K11 at train_s1024's
    shape (b = 1, 1024 tokens, causal; SDPA's backward beside them) in bf16
    and in f32, K8 at the api shape (check_api_dense: 2048 tokens, causal,
    ALiBi, dropout; with K7 and K9-K11 held there under those options) and
    K8 f32 there. Each row: ms, plain_ms, bound, library_ms, err, tol.
    Returns {name: row}."""
    from xf_flash_attention_cutlass_tpu_torch.ops.flash_fwd import (
        attention_mask,
        attention_probs,
        attention_probs_ref,
        flash_fwd_ref,
    )

    out = {}
    for d in HEAD_DIM_TIMED:
        cfg = dataclasses.replace(phi3_config(), head_dim_override=d)
        (q, k, v, do), kw = flash_case(gen, 1, 32, 32, 1024, 1024, d, dict(causal=True))
        o, lse, worst = bwd_width(checks, f"timed,s1024,d={d}", (q, k, v, do), kw)
        for name, row in time_flash_bwd(timer, (q, k, v, o, lse, do), kw, worst).items():
            out[f"{name}@d{d}"] = row
        (q, k, v, do), kw = f32_case(gen, 1, 32, 32, 1024, 1024, d, dict(causal=True))
        o, lse, worst = f32_bwd_width(checks, f"timed,s1024,d={d}", (q, k, v, do), kw)
        for name, row in time_f32_bwd(timer, (q, k, v, o, lse, do), kw, worst).items():
            out[f"{name}@d{d}"] = row
        del q, k, v, do, o
        out[f"flash_probs@d{d}"] = check_api_dense(gen, timer, checks, cfg)
        (q, k, _, _), kw = f32_case(gen, 1, 32, 32, API_S, API_S, d,
                                    dict(causal=True, alibi=True, dropout=True))
        _, lse = flash_fwd_ref(q, k, k, **kw)
        probs, err, tol = probs_width(checks, f"timed,api_s2048,d={d}", q, k, lse, kw)
        pairs = 32 * int(attention_mask(1, API_S, API_S, "cuda", causal=True).sum())
        out[f"flash_probs.f32@d{d}"] = dict(
            ms=timer.ms(lambda: attention_probs(q, k, lse, **kw)),
            plain_ms=timer.ms(lambda: attention_probs_ref(q, k, lse, **kw), PLAIN_REPS),
            library_ms=None, bound=bound(nbytes(q, k, lse, probs), 2 * d * pairs, F32_FLOPS),
            err=err, tol=tol)
        del q, k, lse, probs
        torch.cuda.empty_cache()
    return out


def plain_grad_check(gen, cfg, seed, checks, name, dtype, oracle_dtype):
    """The gradient of a 2-layer copy of cfg (1024 tokens) through the
    kernels in dtype, against the same model with the plain versions of K7
    and K9/K10 in the kernels' place, in dtype (the low-precision reference)
    and in oracle_dtype (the oracle), on the card: the 2x rule on every
    parameter's gradient (the worst one reported as `name`)."""
    from xf_flash_attention_cutlass_tpu_torch.models import llama
    from xf_flash_attention_cutlass_tpu_torch.ops.flash_bwd import flash_bwd_ref
    from xf_flash_attention_cutlass_tpu_torch.ops.flash_fwd import flash_fwd_ref

    class Plain(torch.autograd.Function):  # flash_attention with the plain versions
        @staticmethod
        def forward(ctx, q, k, v, causal, kv_lens):
            o, lse = flash_fwd_ref(q, k, v, causal=causal, kv_lens=kv_lens)
            ctx.save_for_backward(q, k, v, o, lse)
            ctx.causal, ctx.kv_lens = causal, kv_lens
            return o, lse

        @staticmethod
        def backward(ctx, do, _dlse):
            q, k, v, o, lse = ctx.saved_tensors
            return (*flash_bwd_ref(q, k, v, o, lse, do, causal=ctx.causal,
                                   kv_lens=ctx.kv_lens), None, None)

    c2 = dataclasses.replace(cfg, n_layers=2)
    base = llama.init_params(gen, c2, dtype=F32)
    tokens = torch.from_numpy(np.random.default_rng(seed + 4).integers(
        0, cfg.vocab_size, (1, 1025))).cuda()
    grads = {}
    kernels = llama.flash_attention
    for run, dt, attention in (("card", dtype, None), ("plain_low", dtype, "plain"),
                               ("plain_oracle", oracle_dtype, "plain")):
        params = {n: ({m: t.to(dt) for m, t in x.items()} if isinstance(x, dict) else x.to(dt))
                  for n, x in base.items()}
        leaves = [params["embed"], params["final_norm"], params["lm_head"],
                  *params["layers"].values()]
        for t in leaves:
            t.requires_grad_(True)
        if attention:
            llama.flash_attention = lambda q, k, v, causal=False, kv_lens=None, fused=None: (
                Plain.apply(q, k, v, causal, kv_lens))
        try:
            grads[run] = torch.autograd.grad(llama.loss_fn(params, tokens, c2), leaves)
        finally:
            llama.flash_attention = kernels
        del params, leaves
    torch.cuda.synchronize()
    worst = None
    for g, glow, gref in zip(grads["card"], grads["plain_low"], grads["plain_oracle"]):
        r = rule_2x(g, glow, gref)
        if worst is None or max(r[0], r[1]) / r[2] > max(worst[0], worst[1]) / worst[2]:
            worst = r
    checks.add(name, max(worst[0], worst[1]) <= worst[2], max_abs_err=worst[1],
               err_vs_oracle=worst[0], tolerance=worst[2], parameters=len(grads["card"]),
               dtype=str(dtype), oracle_dtype=str(oracle_dtype))
    del grads, base
    torch.cuda.empty_cache()


def train_phi3(gen, checks, paths, seed):
    """Phi-3-mini-4k widths uncut (phi3_config: 32 layers, head dim 96) in
    bf16 with random weights from the seed, one 1024-token batch through
    train(): three two-pass SGD steps (K7, K9, K10), one fused (K11), then
    the profiled step, every loss finite and falling; a main path whose
    every K7-K11 launch is at head dim 96 on the rung 128, with no padded
    copy and no plain call; then the gradient of a 2-layer copy against the
    plain versions on the card (plain_grad_check, bf16 against f32).
    Returns the report's row."""
    cfg = phi3_config()
    torch.cuda.reset_peak_memory_stats()
    (ok, row), paths["train_phi3"] = drive("train_phi3", lambda: train(gen, cfg, seed))
    checks.add("train_phi3.loss_falls", ok, losses=row["losses"])
    row["head_dim_launches"] = check_head_dim_96(checks, "train_phi3", PATHS["train_phi3"])
    row["launches"] = paths["train_phi3"]
    plain_grad_check(gen, cfg, seed, checks, "train_phi3.grad_2layer_vs_plain", BF16, F32)
    row["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    print(json.dumps({"train_phi3": row}), flush=True)
    checks.raise_on_failure("train_phi3")
    return row


def api_phi3_calls(gen):
    """The api's calls at Phi-3 attention width (32 heads, d = 96) through
    the wrappers a user calls: flash_attn_func at 2048 tokens, causal, ALiBi,
    dropout 0.1, return_attn_probs, and the gradient of sum(out * w); the
    packed flash_attn_varlen_func over the 8 serving prompts, causal, and its
    gradient. Returns each call's inputs and outputs (api_phi3 checks them)."""
    import xf_flash_attention_cutlass_tpu_torch as xfa
    from xf_flash_attention_cutlass_tpu_torch.utils.testing import alibi_slopes_ref

    h, d = 32, 96

    def randn(*sh):
        return torch.randn(sh, generator=gen, device="cuda").bfloat16()

    out = {}
    xs = [randn(1, API_S, h, d).requires_grad_(True) for _ in range(3)]
    w = randn(1, API_S, h, d)
    slopes = torch.from_numpy(alibi_slopes_ref(h)).cuda()
    o, lse, probs = xfa.flash_attn_func(*xs, dropout_p=API_P, causal=True, alibi_slopes=slopes,
                                        return_attn_probs=True, dropout_seed=API_SEED)
    grads = torch.autograd.grad((o.float() * w.float()).sum(), xs)
    out["dense"] = dict(x=[t.detach() for t in xs], w=w, o=o.detach(), lse=lse, probs=probs,
                        grads=grads, kw=dict(causal=True, alibi_slopes=slopes, dropout_p=API_P,
                                             dropout_seed=API_SEED))
    lens = serving_prompt_lens(0)
    T = sum(lens)
    cu = torch.tensor(np.cumsum([0] + lens), dtype=torch.int32, device="cuda")
    xs = [randn(T, h, d).requires_grad_(True) for _ in range(3)]
    w = randn(T, h, d)
    o = xfa.flash_attn_varlen_func(*xs, cu, cu, max(lens), max(lens), causal=True)
    grads = torch.autograd.grad((o.float() * w.float()).sum(), xs)
    out["packed"] = dict(x=[t.detach() for t in xs], w=w, o=o.detach(), grads=grads, cu=cu)
    return out


def check_api_phi3_outputs(checks, res):
    """api_phi3_calls' outputs against the plain versions on the card: O
    under the 2x rule and the gradients under the 3x rule against the f32
    oracle's (utils/testing.py, given the port's dropout mask), each also
    within that tolerance of the plain version's; the dense plane entry by
    entry against attention_probs_ref on the call's LSE, signs equal. The
    packed call is held over the packed tokens with the segment ids and
    positions the varlen entry builds."""
    from xf_flash_attention_cutlass_tpu_torch.ops.flash_bwd import flash_bwd_ref
    from xf_flash_attention_cutlass_tpu_torch.ops.flash_fwd import (
        attention_probs_ref,
        dropout_keep_mask,
        flash_fwd_ref,
    )
    from xf_flash_attention_cutlass_tpu_torch.ops.varlen import _packed_positions
    from xf_flash_attention_cutlass_tpu_torch.utils.testing import flash_attention_oracle

    def bhsd(t):  # (b, s, h, d), or packed (T, h, d), as the ops take it
        return t[None].transpose(1, 2) if t.dim() == 3 else t.transpose(1, 2)

    for name, r in res.items():
        kw = r.get("kw")
        q, k, v, w = (bhsd(t) for t in (*r["x"], r["w"]))
        b, h, s, _ = q.shape
        okw = dict(kw or {})
        if name == "packed":
            qseg, kseg, qpos, kpos = _packed_positions(r["cu"], r["cu"], s, s)
            kw = dict(causal=True, q_segment_ids=qseg[None], kv_segment_ids=kseg[None],
                      q_positions=qpos[None], kv_positions=kpos[None])
            okw = dict(kw)
        if okw.get("dropout_p"):
            okw["dropout_mask"] = dropout_keep_mask(okw.pop("dropout_seed"), okw["dropout_p"],
                                                    b, h, s, s, "cuda")
        o_plain, lse_plain = flash_fwd_ref(q, k, v, **kw)
        g_plain = flash_bwd_ref(q, k, v, o_plain, lse_plain, w, **kw)

        def oracle(upcast):
            xs = [(t.float() if upcast else t).detach().requires_grad_(True) for t in (q, k, v)]
            out, _ = flash_attention_oracle(*xs, upcast=upcast, **okw)
            return out.detach(), torch.autograd.grad((out.float() * w.float()).sum(), xs)

        (o32, g32), (olp, glp) = oracle(True), oracle(False)
        got_o, got_g = bhsd(r["o"]), [bhsd(g) for g in r["grads"]]
        res_rule = {"o": (max_err(got_o, o32), max_err(got_o, o_plain),
                          2 * max_err(olp, o32) + 1e-5)}
        for g, x, x32, xlp, xp in zip(("dq", "dk", "dv"), got_g, g32, glp, g_plain):
            res_rule[g] = (max_err(x, x32), max_err(x, xp), 3 * max_err(xlp, x32) + 1e-4)
        extra = {}
        if "probs" in r:
            plane = attention_probs_ref(q, k, r["lse"], **kw)
            excess = float(((r["probs"] - plane).abs() - PROBS_RTOL * plane.abs()).max())
            extra = dict(probs_excess_over_relative_tolerance=excess,
                         sign_mismatches=int((torch.signbit(r["probs"])
                                              != torch.signbit(plane)).sum()))
            del plane
        del o32, olp, g32, glp, o_plain, g_plain
        finite = all(bool(torch.isfinite(t).all()) for t in (got_o, *got_g))
        checks.add(f"api_phi3.{name}", finite and all(max(e, pe) <= t for e, pe, t in
                                                      res_rule.values())
                   and extra.get("sign_mismatches", 0) == 0
                   and extra.get("probs_excess_over_relative_tolerance", 0.0) <= PROBS_ATOL,
                   **{f"{n}_err_vs_f32_oracle": x[0] for n, x in res_rule.items()},
                   **{f"{n}_err": x[1] for n, x in res_rule.items()},
                   **{f"{n}_tolerance": x[2] for n, x in res_rule.items()}, **extra)


def api_phi3(gen, checks, paths, seed):
    """The api path at Phi-3 attention width (api_phi3_calls) as a main
    path: K7, K8, K9 and K10, every launch at head dim 96 on the rung 128,
    no padded copy, no plain call; then its outputs against the plain
    versions (check_api_phi3_outputs). Returns the report's row."""
    t0 = time.perf_counter()
    res, paths["api_phi3"] = drive("api_phi3", lambda: api_phi3_calls(gen))
    row = dict(first_call_s=time.perf_counter() - t0, launches=paths["api_phi3"],
               head_dim_launches=check_head_dim_96(checks, "api_phi3", PATHS["api_phi3"]))
    check_api_phi3_outputs(checks, res)
    del res
    torch.cuda.empty_cache()
    print(json.dumps({"api_phi3": row}), flush=True)
    checks.raise_on_failure("api_phi3")
    return row


# ---- main ---------------------------------------------------------------------

# ---- phase 11: serving and training on a dp x tp mesh --------------------------

MESH_TP = (2, 4)  # the tp widths at whose Llama-8B shard shapes K1, K3 and K4 are checked
MESH_TIMEOUT_S = 300  # a mesh rank's process group and the wait for its result


def mesh_store() -> str:
    """A process group's rendezvous: a FileStore in a fresh temporary directory."""
    return "file://" + os.path.join(tempfile.mkdtemp(prefix="xfa_mesh_"), "store")


def replay_profile(eng, n_steps=3):
    """Device time of a replay of the engine's per-step decode graph on its
    static buffers (its last decode step's inputs), from a profiler trace,
    with NCCL's kernels and K1's and K3's by route."""
    g = eng._graphs[(1, False)]

    def replay():
        g.graph.replay()
        torch.cuda.synchronize()

    return profiled(replay, n_steps, groups=dict(nccl="nccl", memcpy="Memcpy", **K1_GROUPS,
                                                 **K3_GROUPS))


def collective_host_us(mesh, rows=8, dim=4096, calls=200):
    """Host microseconds a call of each eager collective takes on the tp
    group (a (rows, dim) bf16 tensor, the decode step's residual rows),
    `calls` calls ended by one synchronize: what a step that is not
    captured in a graph (a prefill chunk: 2 all-reduces a layer and an
    all-gather) pays on the host for each."""
    from xf_flash_attention_cutlass_tpu_torch.utils.collectives import (
        all_gather,
        all_reduce_,
        reduce_scatter,
    )

    group = mesh.get_group("tp")
    x = torch.zeros((rows, dim), dtype=torch.bfloat16, device="cuda")
    out = {}
    for name, op in (("all_reduce", all_reduce_), ("all_gather", all_gather),
                     ("reduce_scatter", reduce_scatter)):
        op(x, group)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            op(x, group)
        torch.cuda.synchronize()
        out[name] = 1e6 * (time.perf_counter() - t0) / calls
    return out


def mesh_serve_tp1(params, cfg, ecfg, single, want, seed, checks, paths):
    """Llama-8B (32 layers, INT8 weights, FP8 cache, chunked prefill) served
    on a tp = 1 mesh over a one-rank NCCL group, through the same requests
    as the single-device chunked engine `single`: the streams must equal
    its `want` token for token (at tp = 1 every collective is a copy or a
    sum of one term, so the arithmetic is the same), every graph replay
    must equal its eager run, and each decode graph must hold the
    reduce-scatter + all-gather structure's 4 collectives a layer and 2
    more. Then both engines' per-step decode graphs are replayed under a
    profiler trace, in turns (single, mesh, mesh, single)."""
    from xf_flash_attention_cutlass_tpu_torch.parallel import make_mesh
    from xf_flash_attention_cutlass_tpu_torch.serve.engine import DecodeEngine

    mesh = make_mesh(tp=1)
    eng = DecodeEngine(params, cfg, ecfg, mesh=mesh)
    eng.add_request(-1, list(range(300)), 2)  # warm-up request, not counted
    eng.run()
    torch.cuda.synchronize()
    serving, paths["serve_mesh_tp1"] = drive("serve_mesh_tp1", lambda: serve(eng, cfg, seed))
    got = {rid: list(eng.results[rid]) for rid in want}
    checks.add("serve_mesh.tp1_token_identical", got == want,
               differing=[rid for rid in want if got[rid] != want[rid]])
    check_graph_replay(eng, checks, "serve_mesh_tp1")
    coll = {k: v for k, v in eng._graphs[(1, False)].launches.items()
            if k.startswith("collective.")}
    per_step = sum(coll.values())
    checks.add("serve_mesh.tp1_collectives_in_graph", per_step == 4 * cfg.n_layers + 2,
               collectives_per_replay=coll, expected=4 * cfg.n_layers + 2)
    profiles = dict(single=replay_profile(single), mesh=replay_profile(eng))
    profiles.update(mesh_2=replay_profile(eng), single_2=replay_profile(single))
    dev = {k: None if p is None else p["device_ms_per_step"] for k, p in profiles.items()}
    nccl = {k: None if p is None else p["groups_ms_per_step"]["nccl"]
            for k, p in profiles.items()}
    out = dict(serving=serving, collectives_per_step=coll, replay_device_ms=dev,
               replay_nccl_ms=nccl, replay_launches={
                   k: None if p is None else p["launches_per_step"] for k, p in profiles.items()},
               decode_step_ms_p50=serving["decode_step_ms"]["p50"],
               collective_host_us=collective_host_us(mesh))
    print(json.dumps({"serve_mesh_tp1_report": out}), flush=True)
    out["replay_profiles"] = profiles  # the kernels of each trace, in the report
    del eng
    torch.cuda.empty_cache()
    return out


def mesh_train_check(gen, cfg, seed, checks, paths, name, check, rows, step):
    """step(bf16 params, tokens, 2-layer cfg) on a one-rank mesh at Llama-8B
    widths cut to 2 layers, bf16, `rows` batches of 1024 tokens, against
    loss_fn and its gradient on one device: the 3x rule on the loss and on
    every parameter's gradient, the single-device bf16 step the
    low-precision reference and the f32 step (the f32 kernels) the oracle.
    The main path `name` is the step alone."""
    from xf_flash_attention_cutlass_tpu_torch.models.llama import init_params, loss_fn

    c2 = dataclasses.replace(cfg, n_layers=2)
    base = init_params(gen, c2, dtype=torch.float32)
    tokens = torch.from_numpy(np.random.default_rng(seed + 5).integers(
        0, cfg.vocab_size, (rows, 1025))).cuda()

    def cast(dt):
        return {n: ({m: t.to(dt) for m, t in x.items()} if isinstance(x, dict) else x.to(dt))
                for n, x in base.items()}

    def single(dt):
        params = cast(dt)
        names = [("embed",), ("final_norm",), ("lm_head",),
                 *[("layers", n) for n in params["layers"]]]
        leaves = [params[p[0]] if len(p) == 1 else params["layers"][p[1]] for p in names]
        for t in leaves:
            t.requires_grad_(True)
        loss = loss_fn(params, tokens, c2)
        grads = torch.autograd.grad(loss, leaves)
        return float(loss.detach()), dict(zip(names, grads))

    ref_loss, ref = single(torch.float32)
    low_loss, low = single(torch.bfloat16)
    bf16 = cast(torch.bfloat16)
    (loss, grads), paths[name] = drive(name, lambda: step(bf16, tokens, c2))
    worst, errs = 0.0, {}
    for leaf, g_ref in ref.items():
        g = grads[leaf[0]] if len(leaf) == 1 else grads["layers"][leaf[1]]
        err, lp = max_err(g, g_ref), max_err(low[leaf], g_ref)
        tol = 3 * lp + 1e-5
        errs["/".join(leaf)] = dict(err=err, tolerance=tol)
        worst = max(worst, err / tol)
    loss_err, loss_tol = abs(float(loss) - ref_loss), 3 * abs(low_loss - ref_loss) + 1e-5
    checks.add(check, worst <= 1.0 and loss_err <= loss_tol,
               worst_err_over_tolerance=worst, loss=float(loss), loss_f32=ref_loss,
               loss_err=loss_err, loss_tolerance=loss_tol, grads=errs)
    del base, bf16, ref, low, grads
    torch.cuda.empty_cache()
    return dict(loss=float(loss), loss_f32=ref_loss, loss_bf16_single=low_loss,
                worst_err_over_tolerance=worst, launches=paths[name])


def mesh_train_tp1(gen, cfg, seed, checks, paths):
    """tp_loss_and_grad on a tp = 1 mesh, one 1024-token batch, under the 3x
    rule (mesh_train_check)."""
    from xf_flash_attention_cutlass_tpu_torch.parallel import (
        make_mesh,
        shard_params,
        tp_loss_and_grad,
    )

    mesh = make_mesh(tp=1)
    return mesh_train_check(
        gen, cfg, seed, checks, paths, "train_mesh_tp1", "serve_mesh.train_tp1_3x_rule", 1,
        lambda params, tokens, c2: tp_loss_and_grad(shard_params(params, mesh), tokens, c2,
                                                    mesh))


def mesh_shard_kernels(gen, timer, checks, cfg):
    """K1, K3 and K4 at the shard shapes of Llama-8B at tp = 2 and 4 (the
    shapes the card never runs otherwise), each against its plain version:
    K1 over an FP8 cache at decode (8 rows) and a 256-token chunk with the
    shard's heads, K3 over one layer's shard projections at m = 8 (timed)
    and 256, K4 over the lm_head's vocab shard at m = 8 (timed) and 1.
    Returns each width's rows and routes."""
    from xf_flash_attention_cutlass_tpu_torch.ops.paged import paged_route
    from xf_flash_attention_cutlass_tpu_torch.quant.linear import qmm_route

    out = {}
    d, hd = cfg.dim, cfg.head_dim
    for tp in MESH_TP:
        scfg = dataclasses.replace(cfg, n_heads=cfg.n_heads // tp,
                                   n_kv_heads=cfg.n_kv_heads // tp, head_dim_override=hd)
        q_cols, kv_cols, f = scfg.n_heads * hd, scfg.n_kv_heads * hd, cfg.ffn_dim // tp
        layer = [(d, q_cols), (d, kv_cols), (d, kv_cols), (q_cols, d), (d, f), (d, f), (f, d)]
        head = [(d, cfg.vocab_size // tp)]
        n0 = len(checks.cases)
        row = dict(
            k1_decode=check_paged_attention(gen, timer, checks, torch.float8_e4m3fn, "decode",
                                            scfg),
            k1_chunk=check_paged_attention(gen, timer, checks, torch.float8_e4m3fn, "prefill",
                                           scfg),
            k3_layer_m8=check_qmm(gen, timer, checks, torch.int8, 8, layer, True),
            k4_lm_head_m8=check_qmm(gen, timer, checks, torch.int8, 8, head, False))
        check_qmm(gen, timer, checks, torch.int8, 256, layer, True, timed=False)
        check_qmm(gen, timer, checks, torch.int8, 1, head, False, timed=False)
        group = scfg.n_heads // scfg.n_kv_heads
        row["routes"] = dict(
            paged=dict(decode=paged_route(group, 256, hd, torch.float8_e4m3fn),
                       chunk=paged_route(256 * group, 256, hd, torch.float8_e4m3fn)),
            qmm={f"{K}x{N}": dict(m8=qmm_route(8, K, N, torch.int8),
                                  m256=qmm_route(256, K, N, torch.int8))
                 for K, N in dict.fromkeys(layer + head)})
        cases = checks.cases[n0:]
        checks.add(f"serve_mesh.shard_kernels[tp={tp}]", all(c["ok"] for c in cases),
                   cases=len(cases), heads=(scfg.n_heads, scfg.n_kv_heads), routes=row["routes"])
        out[f"tp{tp}"] = row
    print(json.dumps({"mesh_shard_kernels": out}), flush=True)
    return out


@contextlib.contextmanager
def one_rank_group():
    """The default process group as one NCCL rank on the card, for a mesh of
    one rank (make_mesh()); destroyed on exit."""
    import torch.distributed as dist

    torch.cuda.set_device(0)
    store = mesh_store()
    dist.init_process_group("nccl", init_method=store, rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()
        shutil.rmtree(os.path.dirname(store[len("file://"):]), ignore_errors=True)


def mesh_checkpoint_tp1(params, cfg, ecfg, want, seed, checks, n_new=32):
    """A tp = 1 mesh engine (after phase 4's warm-up request) over serve()'s
    8 prompts in a pool of 64 pages (which holds them), saved once its
    prefills are done and 4 decode steps later (save_engine on a mesh: each
    pool's blocks to rank 0's host one leaf at a time, rank 0 writing; the
    save may add no more than 1 MiB to the device's peak), loaded onto
    the mesh (load_engine(..., mesh=)) in a fresh engine and run to the
    end: its streams must equal the uninterrupted single-device run's
    `want`, token for token. Returns the file's size and the save and load
    seconds."""
    from xf_flash_attention_cutlass_tpu_torch.parallel import make_mesh
    from xf_flash_attention_cutlass_tpu_torch.serve import DecodeEngine, load_engine, save_engine

    mesh = make_mesh(tp=1)
    ecfg = dataclasses.replace(ecfg, num_pages=64)
    eng = DecodeEngine(params, cfg, ecfg, mesh=mesh)
    eng.add_request(-1, list(range(300)), 2)  # the warm-up request phase 4 ran first
    eng.run()
    rng = np.random.default_rng(seed)  # serve()'s prompts
    lens = rng.integers(200, 1501, 8)
    for i, n in enumerate(lens):
        eng.add_request(i, rng.integers(0, cfg.vocab_size, int(n)).tolist(), n_new)
    while eng.queue or any(st is not None for st in eng._prefills):
        eng.step()
    for _ in range(4):
        eng.step()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "mesh.npz")
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        save_engine(eng, path)
        out["save_s"] = time.perf_counter() - t0
        out["file_bytes"] = os.path.getsize(path)
        # the save moves each leaf to the host one at a time: no device copy
        out["save_device_bytes_added"] = torch.cuda.max_memory_allocated() - before
        checks.add("serve_mesh.checkpoint_tp1.save_adds_no_device_memory",
                   out["save_device_bytes_added"] <= 1 << 20,
                   device_bytes_added=out["save_device_bytes_added"],
                   pool_bytes=sum(t.nbytes for t in eng.pools.values()))
        del eng
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        resumed = load_engine(path, params=params, mesh=mesh)
        torch.cuda.synchronize()
        out["load_s"] = time.perf_counter() - t0
    streams = resumed.run()
    del resumed
    torch.cuda.empty_cache()
    same = {rid: list(streams[rid]) == want[rid] for rid in want}
    checks.add("serve_mesh.checkpoint_tp1.resumed_streams_equal", all(same.values()),
               per_request=same)
    return out


# dp = 2 x tp = 1 in two processes sharing the card: Llama-8B widths cut to 4
# layers, INT8 weights from seed + 7, an FP8 cache, one prefill lane a replica
DP2_LAYERS = 4
DP2_ECFG = dict(kv_quant="fp8_e4m3", page_size=256, num_pages=64, max_seq=2048, max_batch=8,
                prefill_chunk=256, prefill_lanes=2)
DP2_NEW = 16


def dp2_model(seed):
    from xf_flash_attention_cutlass_tpu_torch.models.llama import (
        LlamaConfig,
        init_params,
        quantize_params,
    )

    cfg = dataclasses.replace(LlamaConfig.llama8b(), n_layers=DP2_LAYERS)
    gen = torch.Generator(device="cuda").manual_seed(seed + 7)
    return cfg, quantize_params(init_params(gen, cfg))


def dp2_prompts(cfg, seed):
    rng = np.random.default_rng(seed + 8)
    return {i: rng.integers(0, cfg.vocab_size, int(n)).tolist()
            for i, n in enumerate(rng.integers(200, 601, 8))}


def dp2_rank(rank, store, seed, conn):
    """One rank of the dp = 2 x tp = 1 mesh (a spawned process): a
    one-rank NCCL tp group of its own, the replicas' exchange over gloo.
    Sends back its replica's streams and recorded logits and the launches
    its run made (cleared just before it)."""
    import torch.distributed as dist
    from datetime import timedelta

    from xf_flash_attention_cutlass_tpu_torch import _build
    from xf_flash_attention_cutlass_tpu_torch.parallel import make_mesh
    from xf_flash_attention_cutlass_tpu_torch.serve.engine import DecodeEngine, EngineConfig

    try:
        torch.cuda.set_device(0)
        dist.init_process_group("cpu:gloo,cuda:nccl", init_method=store, rank=rank,
                                world_size=2, timeout=timedelta(seconds=MESH_TIMEOUT_S))
        try:
            cfg, params = dp2_model(seed)
            eng = DecodeEngine(params, cfg, EngineConfig(**DP2_ECFG), mesh=make_mesh(dp=2))
            torch.cuda.synchronize()
            _build.LAUNCHES.clear()
            _build.PLAIN_CALLS.clear()
            streams, logits, step_ms, _ = serve_recorded(eng, dp2_prompts(cfg, seed), DP2_NEW)
            torch.cuda.synchronize()
            out = dict(rank=rank, streams=streams, launches=dict(_build.LAUNCHES),
                       plain_calls=dict(_build.PLAIN_CALLS),
                       logits={k: v.float().cpu() for k, v in logits.items()},
                       decode_step_ms_p50=percentile(step_ms, 50))
        finally:
            dist.destroy_process_group()
    except Exception as e:  # reported to the parent, which fails the phase
        out = dict(rank=rank, error=repr(e))
    # plain pickle: the tensors travel by value, not as shared memory that
    # would outlive this process
    conn.send_bytes(pickle.dumps(out))
    conn.close()


def mesh_dp2_two_processes(seed, checks, paths):
    """dp = 2 x tp = 1 in two processes on the one card, when its compute
    mode lets two processes hold it: the replicas' streams joined against a
    single-device engine's on the same 4-layer model (the tie rule where
    they part: each replica's decode runs 4 rows where the single engine's
    runs 8, so K3's rounding may differ)."""
    import multiprocessing

    from xf_flash_attention_cutlass_tpu_torch.serve.engine import DecodeEngine, EngineConfig

    mode = subprocess.run(["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    if mode != "Default":
        print(f"serve_mesh.dp2: skipped: the card's compute mode is {mode!r}, which does not "
              "let two processes hold it", flush=True)
        return dict(skipped=f"compute mode {mode}")
    cfg, params = dp2_model(seed)
    eng = DecodeEngine(params, cfg, EngineConfig(**DP2_ECFG))
    ref_s, ref_l, ref_ms, _ = serve_recorded(eng, dp2_prompts(cfg, seed), DP2_NEW)
    del eng, params
    torch.cuda.empty_cache()
    ctx = multiprocessing.get_context("spawn")
    store, procs, conns = mesh_store(), [], []
    for rank in range(2):
        parent, child = ctx.Pipe()
        p = ctx.Process(target=dp2_rank, args=(rank, store, seed, child))
        p.start()
        child.close()
        procs.append(p)
        conns.append(parent)
    try:
        outs = []
        for rank, c in enumerate(conns):
            if not c.poll(MESH_TIMEOUT_S):
                raise RuntimeError(f"serve_mesh.dp2: rank {rank} sent nothing in "
                                   f"{MESH_TIMEOUT_S} s")
            outs.append(pickle.loads(c.recv_bytes()))
    finally:
        for p in procs:
            p.join(30)
            if p.is_alive():
                p.kill()
                p.join(10)
        shutil.rmtree(os.path.dirname(store[len("file://"):]), ignore_errors=True)
    errors = [o["error"] for o in outs if "error" in o]
    if errors:
        raise RuntimeError(f"serve_mesh.dp2: {errors}")
    for o in outs:
        print(json.dumps({f"serve_mesh_dp2.rank{o['rank']}": dict(
            launches=o["launches"], plain_calls=o["plain_calls"])}), flush=True)
        missing = [k for k in PATHS["serve_mesh_dp2"] if not o["launches"].get(k)]
        checks.add(f"serve_mesh.dp2_rank{o['rank']}_path", not missing and not any(
            o["plain_calls"].values()), missing=missing)
    checks.add("serve_mesh.dp2_ranks_agree", outs[0]["streams"] == outs[1]["streams"])
    run_l = {**outs[0]["logits"], **outs[1]["logits"]}
    ref_l = {k: v.float().cpu() for k, v in ref_l.items()}
    rule = tie_rule(checks, "serve_mesh.dp2", (ref_s, ref_l), (outs[0]["streams"], run_l))
    paths["serve_mesh_dp2"] = dict(Counter(outs[0]["launches"]) + Counter(outs[1]["launches"]))
    return dict(compute_mode=mode, layers=DP2_LAYERS, tie_rule=rule,
                decode_step_ms_p50=dict(single=percentile(ref_ms, 50),
                                        **{f"rank{o['rank']}": o["decode_step_ms_p50"]
                                           for o in outs}))


def serve_mesh(gen, timer, params, cfg, ecfg, single, want, seed, checks, paths):
    """Phase 11: the engine and the training step on a mesh (see the module
    docstring). Returns the report's row, with the phase's seconds."""
    t0 = time.perf_counter()
    out = {}
    with one_rank_group():
        out["tp1"] = mesh_serve_tp1(params, cfg, ecfg, single, want, seed, checks, paths)
        checks.raise_on_failure("serve_mesh tp1")
        out["checkpoint_tp1"] = mesh_checkpoint_tp1(params, cfg, ecfg, want, seed, checks)
        print(json.dumps({"serve_mesh_checkpoint_tp1": out["checkpoint_tp1"]}), flush=True)
        checks.raise_on_failure("serve_mesh checkpoint")
        out["train_tp1"] = mesh_train_tp1(gen, cfg, seed, checks, paths)
        checks.raise_on_failure("serve_mesh training")
        out["pp"] = serve_pp(gen, params, cfg, ecfg, seed, checks, paths)
        out["cp"] = serve_cp(gen, cfg, checks, paths)
    out["shard_kernels"] = mesh_shard_kernels(gen, timer, checks, cfg)
    checks.raise_on_failure("serve_mesh shard kernels")
    out["dp2"] = mesh_dp2_two_processes(seed, checks, paths)
    checks.raise_on_failure("serve_mesh dp2")
    out["phase_s"] = time.perf_counter() - t0
    print(json.dumps({"serve_mesh": dict(phase_s=out["phase_s"], dp2=out["dp2"],
                                         train_tp1=out["train_tp1"])}), flush=True)
    return out


# ---- phase 12: expert parallelism -------------------------------------------

def serve_mesh_ep(params, cfg, ecfg, prompts, n_new, want, single, checks, paths):
    """The Mixtral-geometry INT8 params (phase 6's, shared: at one rank each
    expert stack's shard is the stack itself) served on an ep = 1 mesh over
    a one-rank NCCL group, through the ep prefill chunks and decode steps
    (an all-to-all each way a layer, the identity at one rank), over phase
    6's prompts: a main path, its streams held to phase 6's chunked engine
    (`want`) token for token, its graphs to the eager step, its per-step
    graph also to ep_decode_step run eagerly on the same buffers, the
    collectives in that graph counted (2 all-to-alls a layer). Then the
    decode graphs of this engine and of the single-device bucketed engine
    `single` replayed on the same inputs (single's last decode step's) under
    a profiler trace, in turns (single, ep, ep, single). Returns the
    report's row."""
    from xf_flash_attention_cutlass_tpu_torch.models.moe import EXPERT_NAMES
    from xf_flash_attention_cutlass_tpu_torch.parallel import ep_decode_step, make_mesh
    from xf_flash_attention_cutlass_tpu_torch.serve import DecodeEngine

    out = {}
    with one_rank_group():
        mesh = make_mesh(ep=1)
        eng = DecodeEngine(params, cfg, ecfg, mesh=mesh)
        shared = {n: eng.params["layers"][n][0].data_ptr() == params["layers"][n][0].data_ptr()
                  for n in EXPERT_NAMES}
        checks.add("serve_mesh_ep.experts_not_copied", all(shared.values()), shared=shared)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        (streams, _, step_ms, step_tok), paths["serve_mesh_ep"] = drive(
            "serve_mesh_ep", lambda: serve_recorded(eng, prompts, n_new))
        checks.add("serve_mesh_ep.token_identical", streams == want,
                   differing=[rid for rid in want if streams[rid] != want[rid]])
        check_graph_replay(eng, checks, "serve_mesh_ep")
        g, s = eng._graphs[(1, False)], eng._static
        coll = {k: v for k, v in g.launches.items() if k.startswith("collective.")}
        checks.add("serve_mesh_ep.all_to_alls_in_graph",
                   coll.get("collective.all_to_all") == 2 * cfg.n_layers,
                   collectives_per_replay=coll, expected_all_to_alls=2 * cfg.n_layers)
        g.graph.replay()
        toks_g, logits_g = g.tokens[0].clone(), g.logits.clone()
        toks_e, logits_e, _ = ep_decode_step(eng.params, s["tokens"], eng.pools, s["bt"],
                                             s["lens"], cfg, mesh, rope=eng.rope)
        checks.add("serve_mesh_ep.graph_equals_ep_decode_step",
                   torch.equal(toks_g, toks_e)
                   and torch.equal(logits_g.view(torch.int32), logits_e.view(torch.int32)),
                   max_abs_err=max_err(logits_g, logits_e))
        # both graphs on the single engine's last decode inputs (its pages are
        # valid ids of this pool too): the same work, for the A/B below
        for name, t in single._static.items():
            s[name].copy_(t)
        profiles = dict(single=replay_profile(single), ep=replay_profile(eng))
        profiles.update(ep_2=replay_profile(eng), single_2=replay_profile(single))
        dev = {k: None if p is None else p["device_ms_per_step"] for k, p in profiles.items()}
        nccl = {k: None if p is None else p["groups_ms_per_step"]["nccl"]
                for k, p in profiles.items()}
        out = dict(collectives_per_step=coll, replay_device_ms=dev, replay_nccl_ms=nccl,
                   replay_launches={k: None if p is None else p["launches_per_step"]
                                    for k, p in profiles.items()},
                   active_rows=int((s["lens"] > 0).sum()),
                   decode_step_ms=dict(p50=percentile(step_ms, 50), p90=percentile(step_ms, 90)),
                   decode_tok_s=step_tok / (sum(step_ms) / 1e3) if step_ms else None,
                   peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
                   launches=paths["serve_mesh_ep"], stats=dict(eng.stats))
        if dev["single"] is not None and dev["ep"] is not None:
            out["ep_minus_single_device_ms"] = (
                (dev["ep"] + dev["ep_2"]) - (dev["single"] + dev["single_2"])) / 2
        print(json.dumps({"serve_mesh_ep": out}), flush=True)
        out["replay_profiles"] = profiles
        del eng
        torch.cuda.empty_cache()
    return out


def mesh_train_ep(gen, cfg, seed, checks, paths):
    """moe_ep_loss_and_grad on an ep = 1 mesh at Mixtral widths cut to 2
    layers, bf16, one 512-token batch, against moe_loss_fn and its gradient
    on one device: the 3x rule on the loss and on every parameter's
    gradient, the single-device bf16 step the low-precision reference and
    the f32 step (the f32 kernels) the oracle."""
    from xf_flash_attention_cutlass_tpu_torch.models.moe import init_moe_params, moe_loss_fn
    from xf_flash_attention_cutlass_tpu_torch.parallel import (
        make_mesh,
        moe_ep_loss_and_grad,
        shard_moe_params,
    )

    c2 = dataclasses.replace(cfg, n_layers=2)
    base = init_moe_params(gen, c2, dtype=torch.float32)
    tokens = torch.from_numpy(np.random.default_rng(seed + 9).integers(
        0, cfg.vocab_size, (1, 513))).cuda()

    def cast(dt):
        return {n: ({m: t.to(dt) for m, t in x.items()} if isinstance(x, dict) else x.to(dt))
                for n, x in base.items()}

    names = [("embed",), ("final_norm",), ("lm_head",),
             *[("layers", n) for n in base["layers"]]]

    def leaf(tree, name):
        return tree[name[0]] if len(name) == 1 else tree["layers"][name[1]]

    def single(dt):
        params = cast(dt)
        if dt != torch.float32:  # the router stays f32, as init_moe_params makes it
            params["layers"]["router"] = base["layers"]["router"].clone()
        leaves = [leaf(params, n) for n in names]
        for t in leaves:
            t.requires_grad_(True)
        loss = moe_loss_fn(params, tokens, c2)
        grads = torch.autograd.grad(loss, leaves)
        return float(loss.detach()), dict(zip(names, grads))

    ref_loss, ref = single(torch.float32)
    low_loss, low = single(torch.bfloat16)
    bf16 = cast(torch.bfloat16)
    bf16["layers"]["router"] = base["layers"]["router"].clone()
    del base
    with one_rank_group():
        mesh = make_mesh(ep=1)
        (loss, grads), paths["train_mesh_ep"] = drive(
            "train_mesh_ep",
            lambda: moe_ep_loss_and_grad(shard_moe_params(bf16, mesh), tokens, c2, mesh))
    worst, rows = 0.0, {}
    for name, g_ref in ref.items():
        err, lp = max_err(leaf(grads, name), g_ref), max_err(low[name], g_ref)
        tol = 3 * lp + 1e-5
        rows["/".join(name)] = dict(err=err, tolerance=tol)
        worst = max(worst, err / tol)
    loss_err, loss_tol = abs(float(loss) - ref_loss), 3 * abs(low_loss - ref_loss) + 1e-5
    checks.add("serve_mesh_ep.train_3x_rule", worst <= 1.0 and loss_err <= loss_tol,
               worst_err_over_tolerance=worst, loss=float(loss), loss_f32=ref_loss,
               loss_err=loss_err, loss_tolerance=loss_tol, grads=rows)
    del bf16, ref, low, grads
    torch.cuda.empty_cache()
    return dict(layers=2, tokens=512, loss=float(loss), loss_f32=ref_loss,
                loss_bf16_single=low_loss, worst_err_over_tolerance=worst,
                launches=paths["train_mesh_ep"])


def nccl_probe_rank(rank, store, conn):
    """One of two processes on the one card: a two-rank NCCL group and one
    all_to_all_single of a CUDA tensor. Sends back what it received or the
    error."""
    import torch.distributed as dist
    from datetime import timedelta

    try:
        torch.cuda.set_device(0)
        dist.init_process_group("nccl", init_method=store, rank=rank, world_size=2,
                                timeout=timedelta(seconds=60))
        try:
            x = torch.full((2, 4), float(rank), device="cuda")
            y = torch.empty_like(x)
            dist.all_to_all_single(y, x)
            torch.cuda.synchronize()
            out = dict(rank=rank, received=y.cpu().tolist())
        finally:
            dist.destroy_process_group()
    except Exception as e:  # the probe's finding, reported to the parent
        out = dict(rank=rank, error=repr(e)[:2000])
    conn.send_bytes(pickle.dumps(out))
    conn.close()


def nccl_two_process_probe(wait_s=120):
    """Whether two processes can exchange CUDA tensors over NCCL on the one
    card (what an ep = 2 mesh on it needs): each sends a row of its rank to
    the other. Returns the outcome; never raises for NCCL's refusal."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    store, procs, conns = mesh_store(), [], []
    for rank in range(2):
        parent, child = ctx.Pipe()
        p = ctx.Process(target=nccl_probe_rank, args=(rank, store, child))
        p.start()
        child.close()
        procs.append(p)
        conns.append(parent)
    outs = []
    try:
        for rank, c in enumerate(conns):
            outs.append(pickle.loads(c.recv_bytes()) if c.poll(wait_s)
                        else dict(rank=rank, error=f"no answer in {wait_s} s"))
    finally:
        for p in procs:
            p.join(10)
            if p.is_alive():
                p.kill()
                p.join(10)
        shutil.rmtree(os.path.dirname(store[len("file://"):]), ignore_errors=True)
    ok = all(o.get("received") == [[0.0] * 4, [1.0] * 4] for o in outs)
    return dict(ok=ok, ranks=outs)


# ---- phase 13: pipeline parallelism ------------------------------------------

PP_MICRO = 4  # serve_pp1's microbatches (2 rows each)
PP_STEPS = 16  # serve_pp1's decode steps


def pp_decode_state(params, cfg, ecfg, seed):
    """8 requests' decode state after the single-device chunked prefill: a
    chunked engine over 8 prompts of 200-1500 tokens (from seed + 13),
    stepped until every request decodes, its pages grown for PP_STEPS
    tokens. Returns (the engine, tokens (8, 1), block tables, the lengths
    after the first step) on the card; the engine's pools hold the state."""
    from xf_flash_attention_cutlass_tpu_torch.serve.engine import DecodeEngine

    eng = DecodeEngine(params, cfg, ecfg)
    rng = np.random.default_rng(seed + 13)
    for i, n in enumerate(rng.integers(200, 1501, ecfg.max_batch)):
        eng.add_request(i, rng.integers(0, cfg.vocab_size, int(n)).tolist(), 8 * PP_STEPS)
    while len(eng.active) < ecfg.max_batch or any(st is not None for st in eng._prefills):
        eng.step()
    eng._grow(PP_STEPS)
    bt, lens = eng._batch_tables()
    tokens = [[eng.active[slot]["last_token"]] for slot in range(ecfg.max_batch)]
    return (eng, torch.tensor(tokens, device="cuda"), torch.from_numpy(bt).cuda(),
            torch.from_numpy(lens - (PP_STEPS - 1)).cuda())


def host_ms(fn, n=5):
    """p50 host milliseconds of fn() ended by a synchronize, after one
    warm call."""
    fn()
    torch.cuda.synchronize()
    t = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        t.append(1e3 * (time.perf_counter() - t0))
    return percentile(t, 50)


def mesh_serve_pp1(params, cfg, ecfg, seed, checks, paths):
    """Llama-8B (32 layers, phase 4's INT8 params shared, FP8 cache, page
    256) from 8 requests' state after the chunked prefill, through
    PP_STEPS greedy pp_decode_step calls at n_micro = PP_MICRO on a pp = 1
    mesh over a one-rank NCCL group (a main path). Against PP_STEPS
    decode_core runs on each microbatch's rows (the same kernels at the
    same widths): tokens, logits and every pool page bit for bit; against
    the whole-batch decode_core step by the tie rule (K1 splits a 2-row
    microbatch's keys otherwise than an 8-row batch's). Then one step of
    each is profiled, in turns (whole, pp, pp, whole)."""
    from xf_flash_attention_cutlass_tpu_torch.parallel import (
        make_mesh,
        pp_decode_step,
        shard_pp_params,
        shard_pp_pools,
    )
    from xf_flash_attention_cutlass_tpu_torch.serve.engine import decode_core

    mesh = make_mesh(pp=1)
    eng, tokens0, bt, lens0 = pp_decode_state(params, cfg, ecfg, seed)
    pools, trash = eng.pools, eng.trash_page
    mb_pools = {k: v.clone() for k, v in pools.items()}
    whole_pools = {k: v.clone() for k, v in pools.items()}
    sp, spools = shard_pp_params(params, mesh), shard_pp_pools(pools, mesh)
    checks.add("serve_pp1.shards_share_the_params",
               all(a is b for a, b in zip(_leaves(sp), _leaves(params)))
               and all(spools[k] is pools[k] for k in pools))
    b = tokens0.shape[0]
    mb = b // PP_MICRO
    micro = [slice(m * mb, (m + 1) * mb) for m in range(PP_MICRO)]

    def run(step):
        toks, logits, tok = [], [], tokens0
        for i in range(PP_STEPS):
            nt, lg = step(tok, lens0 + i)
            toks.append(nt)
            logits.append(lg)
            tok = nt[:, None]
        return torch.stack(toks), torch.stack(logits)

    def pp_step(tok, lens):
        return pp_decode_step(sp, tok, spools, bt, lens, cfg, mesh, trash, n_micro=PP_MICRO,
                              quant=ecfg.kv_quant)[:2]

    def micro_step(tok, lens):
        outs = [decode_core(params, tok[r], mb_pools, bt[r], lens[r], cfg) for r in micro]
        return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])

    def whole_step(tok, lens):
        return decode_core(params, tok, whole_pools, bt, lens, cfg)

    (pp_toks, pp_logits), paths["serve_pp1"] = drive("serve_pp1", lambda: run(pp_step))
    mb_toks, mb_logits = run(micro_step)
    whole_toks, whole_logits = run(whole_step)
    checks.add("serve_pp1.tokens_equal_per_microbatch_decode_core",
               torch.equal(pp_toks, mb_toks), steps=PP_STEPS, n_micro=PP_MICRO)
    logits_equal = torch.equal(pp_logits.view(torch.uint8), mb_logits.view(torch.uint8))
    differing = [k for k in pools
                 if not torch.equal(pools[k].view(torch.uint8), mb_pools[k].view(torch.uint8))]
    checks.add("serve_pp1.pools_equal_per_microbatch_decode_core", not differing,
               differing=differing, pages=pools["k"].shape[1], trash_page=trash)
    streams = {}
    for name, t in (("pp", pp_toks), ("whole", whole_toks)):
        streams[name] = {rid: t[:, rid].tolist() for rid in range(b)}
    rule = tie_rule(checks, "serve_pp1.whole_batch", (
        streams["whole"], {(rid, i): whole_logits[i, rid].float().cpu()
                           for rid in range(b) for i in range(PP_STEPS)}), (
        streams["pp"], {(rid, i): pp_logits[i, rid].float().cpu()
                        for rid in range(b) for i in range(PP_STEPS)}))
    launches = paths["serve_pp1"]
    shifts = PP_STEPS * PP_MICRO  # n_micro + pp - 1 schedule steps a decode step
    checks.add("serve_pp1.collectives", launches.get("collective.ppermute") == shifts
               and launches.get("collective.all_reduce") == PP_STEPS,
               ppermute=launches.get("collective.ppermute"), expected_ppermute=shifts,
               all_reduce=launches.get("collective.all_reduce"))
    # one step of each on its own pools, the last step's inputs again
    tok, lens = pp_toks[-2][:, None], lens0 + PP_STEPS - 1
    groups = dict(nccl="nccl", **K1_GROUPS, **K3_GROUPS, append=APPEND_KERNEL)
    fns = dict(whole=lambda: whole_step(tok, lens), pp=lambda: pp_step(tok, lens))
    profiles = {}
    for key in ("whole", "pp", "pp_2", "whole_2"):
        profiles[key] = profiled(fns[key.split("_")[0]], 3, groups=groups)
    host = {key: host_ms(fns[key.split("_")[0]]) for key in ("whole", "pp", "pp_2", "whole_2")}

    def field(key, *path):
        p = profiles[key]
        for k in path:
            p = None if p is None else p[k]
        return p

    out = dict(layers=cfg.n_layers, batch=b, n_micro=PP_MICRO, steps=PP_STEPS,
               kv_lens_first_step=lens0.tolist(), logits_bit_equal_per_microbatch=logits_equal,
               tie_rule=rule, launches=launches,
               device_ms_per_step={k: field(k, "device_ms_per_step") for k in profiles},
               k3_k4_ms_per_step={k: field(k, "groups_ms_per_step", "k3_decode")
                                  for k in profiles},
               k1_ms_per_step={k: None if profiles[k] is None else
                               profiles[k]["groups_ms_per_step"]["k1_decode"]
                               + profiles[k]["groups_ms_per_step"]["k1_combine"]
                               for k in profiles},
               launches_per_step={k: field(k, "launches_per_step") for k in profiles},
               host_ms_p50=host)
    print(json.dumps({"serve_pp1_report": out}), flush=True)
    out["profiles"] = profiles
    del eng, pools, mb_pools, whole_pools, spools
    torch.cuda.empty_cache()
    return out


def mesh_train_pp1(gen, cfg, seed, checks, paths):
    """pp_loss_and_grad on a pp = 1 mesh, two 1024-token batches in
    n_micro = 2 microbatches through the written-out GPipe schedule (the
    stage shift forward, the reverse shift backward), under the 3x rule
    (mesh_train_check)."""
    from xf_flash_attention_cutlass_tpu_torch.parallel import (
        make_mesh,
        pp_loss_and_grad,
        shard_pp_params,
    )

    mesh = make_mesh(pp=1)
    return mesh_train_check(
        gen, cfg, seed, checks, paths, "train_pp1", "serve_pp.train_pp1_3x_rule", 2,
        lambda params, tokens, c2: pp_loss_and_grad(shard_pp_params(params, mesh), tokens, c2,
                                                    mesh, n_micro=2))


def serve_pp(gen, params, cfg, ecfg, seed, checks, paths):
    """Phase 13, inside phase 11's one-rank NCCL group (see the module
    docstring). Returns the report's row, with the phase's seconds."""
    t0 = time.perf_counter()
    out = dict(serve_pp1=mesh_serve_pp1(params, cfg, ecfg, seed, checks, paths))
    checks.raise_on_failure("serve_pp1")
    out["train_pp1"] = mesh_train_pp1(gen, cfg, seed, checks, paths)
    checks.raise_on_failure("train_pp1")
    out["phase_s"] = time.perf_counter() - t0
    print(json.dumps({"serve_pp": dict(phase_s=out["phase_s"], train_pp1=out["train_pp1"])}),
          flush=True)
    return out


# ---- phase 14: sequence parallelism ------------------------------------------

CP_TOKENS = 8192  # cp = 1: the sequence through the real transport
CP4_TOKENS = 16384  # the cp = 4 schedule in one process: 4096 tokens a rank
CP_N = 4


def cp_inputs(gen, cfg, s):
    """q, dO (1, 32, s, 128) and k, v (1, 8, s, 128) in bf16: Llama-8B's
    attention at full width."""
    hq, hk, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v, do = (torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
                   for shape in ((1, hq, s, d), (1, hk, s, d), (1, hk, s, d), (1, hq, s, d)))
    return q, k, v, do


def with_grads(fn, q, k, v, do):
    """fn(q, k, v) -> (O, LSE) and its gradient against dO: (O, LSE, dq,
    dk, dv), and the collectives issued by the forward and by the
    backward."""
    from xf_flash_attention_cutlass_tpu_torch import _build

    def issued(before):
        return {n: c - before.get(n, 0) for n, c in _build.LAUNCHES.items()
                if n.startswith("collective.") and c != before.get(n, 0)}

    xs = [t.detach().requires_grad_(True) for t in (q, k, v)]
    before = dict(_build.LAUNCHES)
    o, lse = fn(*xs)
    fwd, before = issued(before), dict(_build.LAUNCHES)
    grads = torch.autograd.grad(o, xs, do)
    torch.cuda.synchronize()
    return (o.detach(), lse, *grads), fwd, issued(before)


def cp_oracle(q, k, v, do, causal=True):
    """The f32 oracle (utils/testing.py flash_attention_oracle) head by
    head: O, LSE, dQ, dK, dV in f32 (dK and dV summed over each kv head's
    group)."""
    from xf_flash_attention_cutlass_tpu_torch.utils.testing import flash_attention_oracle

    g = q.shape[1] // k.shape[1]
    f32 = dict(dtype=torch.float32, device=q.device)
    o, dq = torch.empty(q.shape, **f32), torch.empty(q.shape, **f32)
    lse = torch.empty(q.shape[:3], **f32)
    dk, dv = torch.zeros(k.shape, **f32), torch.zeros(k.shape, **f32)
    for hq in range(q.shape[1]):
        kv = hq // g
        xs = [t[:, i:i + 1].float().requires_grad_(True) for t, i in ((q, hq), (k, kv), (v, kv))]
        oh, lh = flash_attention_oracle(*xs, causal=causal)
        gq, gk, gv = torch.autograd.grad(oh, xs, do[:, hq:hq + 1].float())
        o[:, hq], lse[:, hq], dq[:, hq] = oh[:, 0].detach(), lh[:, 0].detach(), gq[:, 0]
        dk[:, kv] += gk[:, 0]
        dv[:, kv] += gv[:, 0]
    return o, lse, dq, dk, dv


CP_PARTS = ("o", "lse", "dq", "dk", "dv")


def cp_rule(checks, name, got, low, oracle):
    """The 2x rule on O and LSE (twice the low-precision run's error
    against the f32 oracle, plus 1e-5) and the 3x rule on the gradients
    (plus 1e-4), as check_flash_fwd_inputs and check_flash_bwd_inputs
    hold K7 and K9-K11. Returns each part's (error, tolerance)."""
    res = {}
    for part, x, lp, ref in zip(CP_PARTS, got, low, oracle):
        mult, atol = (2, 1e-5) if part in ("o", "lse") else (3, 1e-4)
        res[part] = (max_err(x, ref), mult * max_err(lp, ref) + atol)
    checks.add(name, all(bool(torch.isfinite(x).all()) for x in got)
               and all(e <= t for e, t in res.values()),
               **{f"{p}_err": e for p, (e, _) in res.items()},
               **{f"{p}_tolerance": t for p, (_, t) in res.items()})
    return res


def cp1_calls(group):
    """The entry points at cp = 1 over `group`, each as fn(q, k, v) -> (O,
    LSE), beside the dense flash_attention call with the masks its hop
    uses (None for the zigzag ring, whose halves merge in f32)."""
    from xf_flash_attention_cutlass_tpu_torch.ops.flash import flash_attention
    from xf_flash_attention_cutlass_tpu_torch.parallel import (
        ring_attention,
        ring_attention_zigzag,
        ulysses_attention,
        zigzag_permute,
        zigzag_unpermute,
    )

    def zigzag(q, k, v):
        o, lse = ring_attention_zigzag(*(zigzag_permute(x, 1, 2) for x in (q, k, v)), group)
        return zigzag_unpermute(o, 1, 2), zigzag_unpermute(lse, 1, 2)

    return {
        "ring_causal": (lambda q, k, v: ring_attention(q, k, v, group, causal=True),
                        lambda q, k, v: flash_attention(q, k, v, causal=True)),
        "ring": (lambda q, k, v: ring_attention(q, k, v, group, causal=False),
                 lambda q, k, v: flash_attention(q, k, v, causal=False)),
        "ulysses": (lambda q, k, v: ulysses_attention(q, k, v, group, causal=True),
                    lambda q, k, v: flash_attention(q, k, v, causal=True)),
        "zigzag": (zigzag, None),
    }


# the collectives each entry point issues at cp = 1: the forward rotates
# n - 1 = 0 times, the backward 4 tensors a hop and 2 to deliver; Ulysses
# exchanges q, k, v, O and LSE, and back the cotangents of O, q, k, v
CP1_COLLECTIVES = {
    "ring": ({}, {"collective.ppermute": 6}),
    "ulysses": ({"collective.all_to_all": 5}, {"collective.all_to_all": 4}),
}


def mesh_cp1(gen, cfg, checks, paths):
    """The three entry points on a cp = 1 mesh over the one-rank NCCL group
    at Llama-8B attention width, CP_TOKENS tokens, forward and backward
    (main paths train_cp1_ring, _zigzag, _ulysses): the ring (causal and
    not) and Ulysses equal to flash_attention over the same tensors with
    the same masks bit for bit (one hop, identity exchanges); the zigzag
    ring under the 2x / 3x rule against the f32 oracle, the dense
    flash_attention the low-precision run; the collectives counted. Then a
    CUDA tensor on a gloo group must raise, naming the backend."""
    import torch.distributed as dist

    from xf_flash_attention_cutlass_tpu_torch.parallel import make_mesh, ring_attention

    group = make_mesh(cp=1).get_group("cp")
    q, k, v, do = cp_inputs(gen, cfg, CP_TOKENS)
    calls, runs = cp1_calls(group), {}
    for path, names in (("train_cp1_ring", ("ring_causal", "ring")),
                        ("train_cp1_zigzag", ("zigzag",)), ("train_cp1_ulysses", ("ulysses",))):
        out, paths[path] = drive(path, lambda: {n: with_grads(calls[n][0], q, k, v, do)
                                                for n in names})
        runs.update(out)
    out = {}
    for name, (got, fwd, bwd) in runs.items():
        dense = calls[name][1]
        want = CP1_COLLECTIVES.get(name.split("_")[0], CP1_COLLECTIVES["ring"])
        checks.add(f"serve_cp.cp1_{name}_collectives", (fwd, bwd) == want, forward=fwd,
                   backward=bwd, expected=want)
        if dense is not None:
            ref = with_grads(dense, q, k, v, do)[0]
            same = {p: bool(torch.equal(x, y)) for p, x, y in zip(CP_PARTS, got, ref)}
            checks.add(f"serve_cp.cp1_{name}_bit_equal_flash_attention", all(same.values()),
                       **same, max_abs_err=max(max_err(x, y) for x, y in zip(got, ref)))
            out[name] = dict(bit_equal=same, forward=fwd, backward=bwd)
        else:
            low = with_grads(calls["ring_causal"][1], q, k, v, do)[0]
            rule = cp_rule(checks, f"serve_cp.cp1_{name}_2x_3x_rule", got, low,
                           cp_oracle(q, k, v, do))
            out[name] = dict(rule=rule, forward=fwd, backward=bwd)
    gloo = dist.new_group(backend="gloo")
    try:
        ring_attention(q[:, :, :64], k[:, :, :64], v[:, :, :64], gloo)
        raised = None
    except ValueError as e:
        raised = str(e)
    finally:
        dist.destroy_process_group(gloo)
    checks.add("serve_cp.cuda_on_gloo_raises", raised is not None and "gloo" in raised,
               message=raised)
    del q, k, v, do, runs
    torch.cuda.empty_cache()
    return out


def timed_schedule(schedule, spans):
    """A schedule (parallel/ring.py) passed through, with a CUDA event pair
    appended to `spans` around each part it runs between two rotations:
    one rank's share of the stream in ring.lockstep."""
    handle = None
    while True:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        try:
            out = schedule.send(handle)
        except StopIteration as stop:
            end.record()
            spans.append((start, end))
            return stop.value
        end.record()
        spans.append((start, end))
        handle = yield out


def cp4_rings(q, k, v, do, causal=True, zigzag=False, spans=None):
    """Every rank's forward and backward schedule of a cp = 4 ring in one
    process (ring.lockstep), through the module's hops, merges and dK/dV
    accumulators. Returns the global (O, LSE, dq, dk, dv); with `spans`,
    each rank's event pairs go to spans[rank]."""
    from xf_flash_attention_cutlass_tpu_torch.parallel import ring

    n = CP_N
    if zigzag:
        q, k, v, do = (ring.zigzag_permute(x, n, 2) for x in (q, k, v, do))
        fwd = functools.partial(ring.zigzag_hop_fwd, softmax_scale=None)
        bwd = functools.partial(ring.zigzag_hop_bwd, softmax_scale=None)
    else:
        fwd = functools.partial(ring.ring_hop_fwd, causal=causal, softmax_scale=None)
        bwd = functools.partial(ring.ring_hop_bwd, causal=causal, softmax_scale=None)
    cq, ck, cv, cdo = (x.chunk(n, dim=2) for x in (q, k, v, do))

    def run(schedules):
        if spans is None:
            return ring.lockstep(schedules)
        return ring.lockstep([timed_schedule(s, spans[i]) for i, s in enumerate(schedules)])

    outs = run([ring.fwd_schedule(fwd, cq[i], ck[i], cv[i], i, n) for i in range(n)])
    grads = run([ring.bwd_schedule(bwd, cq[i], ck[i], cv[i], *outs[i], cdo[i], i, n)
                 for i in range(n)])
    res = [torch.cat([x[j] for x in outs], dim=2) for j in range(2)]
    res += [torch.cat([g[j] for g in grads], dim=2) for j in range(3)]
    return [ring.zigzag_unpermute(x, n, 2) for x in res] if zigzag else res


def cp4_ulysses(group, q, k, v, do):
    """Each rank's head slice of a cp = 4 Ulysses (8 q / 2 kv heads over the
    whole sequence, what the exchanges hand rank i), through
    ulysses_attention on a one-rank group. Returns the global (O, LSE, dq,
    dk, dv)."""
    from xf_flash_attention_cutlass_tpu_torch.parallel import ulysses_attention

    hq, hk = q.shape[1] // CP_N, k.shape[1] // CP_N
    parts = [with_grads(lambda a, b, c: ulysses_attention(a, b, c, group, causal=True),
                        q[:, i * hq:(i + 1) * hq], k[:, i * hk:(i + 1) * hk],
                        v[:, i * hk:(i + 1) * hk], do[:, i * hq:(i + 1) * hq])[0]
             for i in range(CP_N)]
    return [torch.cat([p[j] for p in parts], dim=1) for j in range(5)]


def cp_hop_times(timer, q, k, v, do, o, lse):
    """Timer ms of each hop kind's forward and backward (parallel/ring.py's
    hop functions) at the cp = 4 shapes, with its operations bound: the
    plain ring's diagonal and full hops (rank 3 over its own chunk and over
    rank 0's) and the zigzag ring's diag, lo and hi (rank 0 own, rank 3 over
    rank 0's, rank 0 over rank 3's). The backward takes the global O and
    LSE's chunks. The bound counts 4 d operations a visible pair forward, 14
    d backward (K9's three products and K10's four)."""
    from xf_flash_attention_cutlass_tpu_torch.parallel import ring

    n, (h, d) = CP_N, (q.shape[1], q.shape[3])
    zz = [ring.zigzag_permute(x, n, 2).chunk(n, dim=2) for x in (q, k, v, do, o, lse)]
    pl = [x.chunk(n, dim=2) for x in (q, k, v, do, o, lse)]
    s = q.shape[2] // n
    sh = s // 2
    pairs = dict(diag=s * (s + 1) // 2, full=s * s, zz_diag=sh * (sh + 1) + sh * sh,
                 zz_lo=2 * sh * sh, zz_hi=2 * sh * sh)
    cases = dict(diag=(pl, 3, 3, "ring", dict(causal=True)),
                 full=(pl, 3, 0, "ring", dict(causal=True)),
                 zz_diag=(zz, 0, 0, "zigzag", {}), zz_lo=(zz, 3, 0, "zigzag", {}),
                 zz_hi=(zz, 0, 3, "zigzag", {}))
    out = {}
    for kind, (xs, i, src, family, kw) in cases.items():
        cq, ck, cv, cdo, co, cl = xs
        fwd = getattr(ring, f"{family}_hop_fwd")
        bwd = getattr(ring, f"{family}_hop_bwd")
        out[kind] = dict(
            fwd_ms=timer.ms(lambda: fwd(cq[i], ck[src], cv[src], i, src, softmax_scale=None,
                                        **kw)),
            bwd_ms=timer.ms(lambda: bwd(cq[i], ck[src], cv[src], co[i], cl[i], cdo[i], i, src,
                                        softmax_scale=None, **kw)),
            fwd_bound_ms=bound(0, 4 * d * h * pairs[kind])[0],
            bwd_bound_ms=bound(0, 14 * d * h * pairs[kind])[0], pairs_per_head=pairs[kind])
    return out


def cp4_rank_times(q, k, v, do, reps=3):
    """Device ms of each rank's share of the cp = 4 ring and zigzag ring
    (forward and backward, timed_schedule), the mean of `reps` runs after a
    warm one; the card spins first, so that the host queues ahead."""
    out = {}
    for name, kw in (("ring", {}), ("zigzag", dict(zigzag=True))):
        cp4_rings(q, k, v, do, **kw)
        runs = []
        for _ in range(reps):
            spans = [[] for _ in range(CP_N)]
            torch.cuda._sleep(SLEEP_CYCLES)
            cp4_rings(q, k, v, do, spans=spans, **kw)
            torch.cuda.synchronize()
            runs.append([sum(s.elapsed_time(e) for s, e in r) for r in spans])
        ranks = [sum(r[i] for r in runs) / reps for i in range(CP_N)]
        out[name] = dict(rank_ms=ranks, slowest_ms=max(ranks), sum_ms=sum(ranks))
    out["slowest_ring_over_zigzag"] = out["ring"]["slowest_ms"] / out["zigzag"]["slowest_ms"]
    return out


def mesh_cp4(gen, cfg, checks, paths):
    """The cp = 4 schedule in one process at CP4_TOKENS tokens (main path
    train_cp4_schedule): the ring and the zigzag ring, every rank's hops
    through the module's schedules in lockstep, and each rank's head slice
    of Ulysses; O, LSE and the gradients under the 2x / 3x rule against the
    f32 oracle, the dense flash_attention over the whole sequence (K7,
    K9/K10) the low-precision run. Then each hop kind's times, each rank's
    device time and the dense kernels' over the whole sequence."""
    from xf_flash_attention_cutlass_tpu_torch.ops.flash import flash_attention
    from xf_flash_attention_cutlass_tpu_torch.ops.flash_bwd import flash_bwd
    from xf_flash_attention_cutlass_tpu_torch.ops.flash_fwd import flash_fwd
    from xf_flash_attention_cutlass_tpu_torch.parallel import make_mesh

    group = make_mesh(cp=1).get_group("cp")
    q, k, v, do = cp_inputs(gen, cfg, CP4_TOKENS)
    got, paths["train_cp4_schedule"] = drive("train_cp4_schedule", lambda: dict(
        ring=cp4_rings(q, k, v, do), zigzag=cp4_rings(q, k, v, do, zigzag=True),
        ulysses=cp4_ulysses(group, q, k, v, do)))
    low = with_grads(lambda a, b, c: flash_attention(a, b, c, causal=True), q, k, v, do)[0]
    oracle = cp_oracle(q, k, v, do)
    out = {name: cp_rule(checks, f"serve_cp.cp4_{name}_2x_3x_rule", x, low, oracle)
           for name, x in got.items()}
    del got, oracle
    torch.cuda.empty_cache()
    timer = Timer()
    out["hops"] = cp_hop_times(timer, q, k, v, do, low[0], low[1])
    out["ranks"] = cp4_rank_times(q, k, v, do)
    out["dense"] = dict(fwd_ms=timer.ms(lambda: flash_fwd(q, k, v, causal=True)),
                        bwd_ms=timer.ms(lambda: flash_bwd(q, k, v, low[0], low[1], do,
                                                          causal=True)))
    dense = out["dense"]["fwd_ms"] + out["dense"]["bwd_ms"]
    out["sum_over_ranks_over_dense"] = {n: out["ranks"][n]["sum_ms"] / dense
                                        for n in ("ring", "zigzag")}
    del q, k, v, do, low, timer
    torch.cuda.empty_cache()
    return out


def serve_cp(gen, cfg, checks, paths):
    """Phase 14, inside phase 11's one-rank NCCL group (see the module
    docstring). Returns the report's row, with the phase's seconds."""
    t0 = time.perf_counter()
    out = dict(cp1=mesh_cp1(gen, cfg, checks, paths))
    checks.raise_on_failure("serve_cp cp1")
    out["cp4"] = mesh_cp4(gen, cfg, checks, paths)
    checks.raise_on_failure("serve_cp cp4")
    out["phase_s"] = time.perf_counter() - t0
    print(json.dumps({"serve_cp": out}), flush=True)
    return out


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
# the fp16 and f32 instantiations (phase 7), each beside the kernel it instantiates
_K1 = (_PKG + "paged_attention.cu", _TPU + "ops/paged.py:97")
_K3 = (_PKG + "qmm.cu", _TPU + "quant/linear.py:70")
_K4 = (_PKG + "qmm.cu", _TPU + "quant/linear.py:48")
KERNELS.update({
    "paged_attention.decode.f16": _K1, "paged_attention.combine.f16": _K1,
    "paged_attention.decode.options.f16": _K1, "paged_attention.decode.wmma.f16": _K1,
    "paged_attention.prefill.wgmma.f16": _K1, "paged_attention.prefill.options.f16": _K1,
    "paged_attention.decode.f32": _K1, "paged_attention.prefill.f32": _K1,
    "paged_attention.combine.f32": _K1,
    "paged_append.decode.f16": (_PKG + "paged_append.cu", _TPU + "ops/paged_append.py:68"),
    "paged_append.prefill.f16": (_PKG + "paged_append.cu", _TPU + "ops/paged_append.py:166"),
    "paged_append.decode.f32": (_PKG + "paged_append.cu", _TPU + "ops/paged_append.py:68"),
    "paged_append.prefill.f32": (_PKG + "paged_append.cu", _TPU + "ops/paged_append.py:166"),
    "qmm.stacked.decode.f16": _K3, "qmm.stacked.wgmma.f16": _K3, "qmm.stacked.bm16.f16": _K3,
    "qmm.stacked.bm64.f16": _K3, "qmm.single.decode.f16": _K4, "qmm.single.wgmma.f16": _K4,
    "qmm.stacked.f32": _K3, "qmm.single.f32": _K4,
})
# the dense flash family's fp16 K7 (phase 7's serve_fp16) and f32 kernels (phase 8)
_F32 = _PKG + "flash_f32.cu"
KERNELS.update({
    "flash_fwd.f16": (_PKG + "flash_fwd.cu", _TPU + "ops/flash_fwd.py:100"),
    "flash_fwd.f32": (_F32, _TPU + "ops/flash_fwd.py:100"),
    "flash_probs.f32": (_F32, _TPU + "ops/flash_fwd.py:379"),
    "flash_bwd.dq.f32": (_F32, _TPU + "ops/flash_bwd.py:228"),
    "flash_bwd.dkv.f32": (_F32, _TPU + "ops/flash_bwd.py:284"),
    "flash_bwd.fused.f32": (_F32, _TPU + "ops/flash_bwd.py:156"),
})
# the kernels each main path must launch (and it may call no plain version);
# the engine's decode splits (paged_plan: 4 at b = 8) run the combine kernel.
# Every decode step is the replay of a CUDA graph (`graph.decode`, a window
# of several: `graph.decode_multi_step`), which adds the launches its
# capture counted; the speculative path verifies 3 tokens a request (K1's
# decode route at 12 rows, K3/K4's wgmma route at m = 24) and never decodes
_SERVE_KERNELS = ["paged_attention.decode", "paged_attention.combine", "paged_append.decode",
                  "qmm.stacked.decode", "qmm.stacked.wgmma", "qmm.single.decode"]
_CHUNKED = ["paged_attention.prefill.wgmma", "paged_append.prefill"]
_PHI3_SERVING = [k for k in _SERVE_KERNELS if k != "paged_attention.combine"]
_BUCKETED = ["flash_fwd", "paged_append.prefill"]
PATHS = {
    "serve_chunked": _SERVE_KERNELS + _CHUNKED + ["graph.decode"],
    "serve_bucketed": _SERVE_KERNELS + _BUCKETED + ["graph.decode"],
    "train": ["flash_fwd", "flash_bwd.dq", "flash_bwd.dkv", "flash_bwd.fused"],
    "api": ["flash_fwd", "flash_probs", "flash_bwd.dq", "flash_bwd.dkv",
            "paged_attention.decode", "paged_attention.decode.options",
            "paged_attention.prefill.wgmma", "paged_attention.prefill.options"],
    "serve_multi_step": _SERVE_KERNELS + _CHUNKED + ["graph.decode", "graph.decode_multi_step"],
    "serve_sampled": _SERVE_KERNELS + _BUCKETED + ["graph.decode_multi_step"],
    "serve_speculative": _BUCKETED + ["paged_attention.decode", "paged_attention.combine",
                                      "qmm.stacked.wgmma", "qmm.single.wgmma",
                                      "qmm.single.decode"],
    "serve_prefix": _SERVE_KERNELS + _CHUNKED + ["graph.decode"],
    # the MoE family: every expert projection on K3 (stacked at l * E + e),
    # the decode route at the decode's capacity (8 rows), the wgmma route at
    # a chunk's or a bucket's (80-640 rows)
    "serve_moe_chunked": _SERVE_KERNELS + _CHUNKED + ["graph.decode"],
    "serve_moe_bucketed": _SERVE_KERNELS + _BUCKETED + ["graph.decode"],
    "train_moe": ["flash_fwd", "flash_bwd.dq", "flash_bwd.dkv"],
    # phase 7: Llama-8B in fp16 (INT8 weights, FP8 cache, bucketed prefill:
    # K7 in fp16) and in f32 (f32 weights and cache, chunked prefill; the
    # lm_head is a plain f32 tensor, so torch.matmul, as in the JAX engine)
    "serve_fp16": ["flash_fwd.f16", "paged_append.prefill.f16", "paged_append.decode.f16",
                   "paged_attention.decode.f16", "paged_attention.combine.f16",
                   "qmm.stacked.decode.f16", "qmm.stacked.wgmma.f16", "qmm.single.decode.f16",
                   "graph.decode"],
    "serve_f32": ["paged_append.prefill.f32", "paged_append.decode.f32",
                  "paged_attention.prefill.f32", "paged_attention.decode.f32",
                  "paged_attention.combine.f32", "qmm.stacked.f32", "graph.decode"],
    "api_dtypes": ["paged_attention.decode.f16", "paged_attention.prefill.wgmma.f16",
                   "paged_attention.decode.options.f16", "paged_attention.prefill.options.f16",
                   "paged_attention.decode.f32", "paged_attention.prefill.f32"],
    # phase 8: the dense flash family in f32 (bucketed f32 prefill, f32
    # training cut to 8 layers, the api's f32 dense calls)
    "serve_f32_bucketed": ["flash_fwd.f32", "paged_append.prefill.f32",
                           "paged_append.decode.f32", "paged_attention.decode.f32",
                           "paged_attention.combine.f32", "qmm.stacked.f32", "graph.decode"],
    "train_f32": ["flash_fwd.f32", "flash_bwd.dq.f32", "flash_bwd.dkv.f32",
                  "flash_bwd.fused.f32"],
    "api_f32": ["flash_fwd.f32", "flash_probs.f32", "flash_bwd.dq.f32", "flash_bwd.dkv.f32"],
    # phase 9: Phi-3-mini widths (head dim 96) with INT8 weights and an FP8
    # cache. Its 32 KV heads fill the card without a split: a decode step's
    # 256 blocks (b = 8) and a 256-row chunk's 128 (padded to the chunk)
    # reach num_splits_heuristic's 80 % of the cores, so no combine runs
    # here (phase 9's kernel checks hold it at d = 96)
    "serve_phi3_chunked": _PHI3_SERVING + _CHUNKED + ["graph.decode"],
    "serve_phi3_bucketed": _PHI3_SERVING + _BUCKETED + ["graph.decode"],
}
# kernels a main path must not launch: serving decodes on K1's and K3/K4's
# decode kernels, and the api path's options take K1's Hopper kernels
_NOT_SERVING = ["paged_attention.decode.wmma", "qmm.stacked.bm16", "qmm.single.bm16"]
_MOE_NOT_SERVING = ["qmm.stacked.bm64", "qmm.single.bm64", "paged_attention.prefill.wmma"]
NOT_ON_PATH = {"serve_chunked": _NOT_SERVING, "serve_bucketed": _NOT_SERVING,
               "serve_multi_step": _NOT_SERVING, "serve_sampled": _NOT_SERVING,
               "serve_speculative": _NOT_SERVING + ["graph.decode", "paged_append.decode"],
               "serve_prefix": _NOT_SERVING,
               "serve_moe_chunked": _NOT_SERVING + _MOE_NOT_SERVING,
               "serve_moe_bucketed": _NOT_SERVING + _MOE_NOT_SERVING,
               "api": ["paged_attention.decode.wmma", "paged_attention.prefill.wmma"]}
# the fp16 path launches none of the bf16 instantiations, and no WMMA kernel;
# the f32 paths nothing but the f32 instantiations (no 16-bit flash kernel)
_BF16_SERVING = _SERVE_KERNELS + _CHUNKED + ["paged_append.prefill"]
_FLASH16 = [k + sfx for k in ("flash_fwd", "flash_probs", "flash_bwd.dq", "flash_bwd.dkv",
                              "flash_bwd.fused") for sfx in ("", ".f16")]
_F16_IN_F32 = ["paged_attention.decode.f16", "paged_append.decode.f16",
               "qmm.stacked.decode.f16"]
NOT_ON_PATH.update({
    "serve_fp16": _BF16_SERVING + _NOT_SERVING + [
        "paged_attention.decode.wmma.f16", "qmm.stacked.bm16.f16", "qmm.single.bm16.f16",
        "qmm.stacked.bm64.f16", "flash_fwd", "flash_fwd.f32"],
    "serve_f32": _BF16_SERVING + _FLASH16 + _F16_IN_F32 + ["flash_fwd.f32"],
    "serve_f32_bucketed": _BF16_SERVING + _FLASH16 + _F16_IN_F32 + [
        "paged_attention.prefill.f32"],
    "train_f32": _FLASH16,
    "api_f32": _FLASH16,
    "api_dtypes": ["paged_attention.decode.wmma.f16", "paged_attention.prefill.wmma.f16"]})
# the head-dim-96 paths read every operand in place: no padded copy, no WMMA kernel
_PHI3_NOT = _NOT_SERVING + ["paged_attention.prefill.wmma", "paged_attention.pad_copy",
                            "flash_fwd.pad_copy"]
NOT_ON_PATH.update({"serve_phi3_chunked": _PHI3_NOT, "serve_phi3_bucketed": _PHI3_NOT})
# phase 10: Phi-3-mini widths trained (K7, K9-K11 at d = 96) and the api's
# dense calls at its attention width (K7, K8, K9, K10), no padded copy
PATHS.update({"train_phi3": ["flash_fwd", "flash_bwd.dq", "flash_bwd.dkv", "flash_bwd.fused"],
              "api_phi3": ["flash_fwd", "flash_probs", "flash_bwd.dq", "flash_bwd.dkv"]})
_PADS = ["flash_fwd.pad_copy", "flash_probs.pad_copy", "flash_bwd.pad_copy"]
NOT_ON_PATH.update({"train_phi3": _PADS + _FLASH16[1::2], "api_phi3": _PADS + _FLASH16[1::2]})
# phase 11: the mesh paths. Every decode graph holds the reduce-scatter +
# all-gather structure's collectives and each prefill chunk the all-reduces,
# issued at a group of one rank too; the training step all-reduces and
# gathers; the dp = 2 ranks (4 rows a replica) also exchange their tokens
_COLLECTIVES = ["collective.all_gather", "collective.reduce_scatter", "collective.all_reduce"]
PATHS.update({
    "serve_mesh_tp1": _SERVE_KERNELS + _CHUNKED + ["graph.decode"] + _COLLECTIVES,
    "train_mesh_tp1": ["flash_fwd", "flash_bwd.dq", "flash_bwd.dkv"] + _COLLECTIVES,
    "serve_mesh_dp2": [k for k in _SERVE_KERNELS if k != "paged_attention.combine"] + _CHUNKED
    + ["graph.decode"] + _COLLECTIVES,
})
NOT_ON_PATH.update({"serve_mesh_tp1": _NOT_SERVING})
# phase 12: expert parallelism. The MoE engine on an ep mesh exchanges the
# dispatched blocks by 2 all-to-alls a layer, all-reduces twice a layer
# (no reduce-scatter structure for MoE) and gathers the logits; the
# training step all-reduces and exchanges
PATHS.update({
    "serve_mesh_ep": _SERVE_KERNELS + _CHUNKED + ["graph.decode", "collective.all_to_all",
                                                  "collective.all_reduce",
                                                  "collective.all_gather"],
    "train_mesh_ep": ["flash_fwd", "flash_bwd.dq", "flash_bwd.dkv", "collective.all_reduce",
                      "collective.all_to_all"],
})
NOT_ON_PATH.update({"serve_mesh_ep": _NOT_SERVING + _MOE_NOT_SERVING})
# phase 13: pipeline parallelism at pp = 1. The decode step's microbatches
# run the decode kernels eagerly (no prefill kernel, no graph), with one
# stage shift a schedule step and the all-reduce that replicates the last
# stage's rows; the training step shifts forward and back
PATHS.update({
    "serve_pp1": [k for k in _SERVE_KERNELS if k != "qmm.stacked.wgmma"]
    + ["collective.ppermute", "collective.all_reduce"],
    "train_pp1": ["flash_fwd", "flash_bwd.dq", "flash_bwd.dkv", "collective.ppermute"],
})
NOT_ON_PATH.update({"serve_pp1": _NOT_SERVING + _CHUNKED + ["qmm.stacked.wgmma",
                                                            "graph.decode"]})
# phase 14: sequence parallelism. At cp = 1 the ring's forward rotates
# nothing and its backward sends to self; Ulysses' exchanges are the
# identity at one rank, and the cp = 4 schedule runs Ulysses' head slices
# on a one-rank group (the rings' rotations there are in-process hand-overs,
# ring.lockstep). Every hop on the two-pass backward, no padded copy
_CP_KERNELS = ["flash_fwd", "flash_bwd.dq", "flash_bwd.dkv"]
PATHS.update({
    "train_cp1_ring": _CP_KERNELS + ["collective.ppermute"],
    "train_cp1_zigzag": _CP_KERNELS + ["collective.ppermute"],
    "train_cp1_ulysses": _CP_KERNELS + ["collective.all_to_all"],
    "train_cp4_schedule": _CP_KERNELS + ["collective.all_to_all"],
})
NOT_ON_PATH.update({p: _PADS + _FLASH16[1::2] + ["flash_bwd.fused", "flash_fwd.f32"]
                    for p in ("train_cp1_ring", "train_cp1_zigzag", "train_cp1_ulysses",
                              "train_cp4_schedule")})


def head_dim_kernels():
    """The kernels line's rows at HEAD_DIM_TIMED ("<label>@d<d>"), each
    beside its source and the TPU kernel it replaces; their launches are
    the head-dim-96 paths' at that label and head dim."""
    out = {}
    for d in HEAD_DIM_TIMED:
        for label in ("paged_attention.decode", "paged_attention.prefill.wgmma",
                      "paged_attention.combine", "paged_attention.decode.f32"):
            out[f"{label}@d{d}"] = _K1
        out[f"flash_fwd@d{d}"] = KERNELS["flash_fwd"]
        out[f"flash_fwd.f32@d{d}"] = KERNELS["flash_fwd.f32"]
        for label in ("flash_probs", *_BWD):
            out[f"{label}@d{d}"] = KERNELS[label]
            out[f"{label}.f32@d{d}"] = KERNELS[f"{label}.f32"]
    return out


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# each main path's launches of K1 and K7 by head dim and rung, from drive
HEAD_DIM_PATHS = {}


def drive(path, fn):
    """Run one main path with the launch counters cleared just before and
    read just after; raise if a kernel of the path never launched or a
    plain version ran. Returns (fn's result, the launch counts); the
    counts by head dim go to HEAD_DIM_PATHS."""
    from xf_flash_attention_cutlass_tpu_torch import _build

    torch.cuda.synchronize()
    _build.LAUNCHES.clear()
    _build.PLAIN_CALLS.clear()
    _build.HEAD_DIM_LAUNCHES.clear()
    result = fn()
    torch.cuda.synchronize()
    launches, plain_calls = dict(_build.LAUNCHES), dict(_build.PLAIN_CALLS)
    HEAD_DIM_PATHS[path] = dict(_build.HEAD_DIM_LAUNCHES)
    print(json.dumps({path: dict(launches=launches, plain_calls=plain_calls,
                                 head_dims=HEAD_DIM_PATHS[path])}), flush=True)
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
    report["qmm_build"] = qmm_build_report(checks, libs)
    report["flash_bwd_build"] = flash_bwd_build_report(checks, libs["flash_bwd"])
    report["paged_build"] = paged_build_report(checks, libs)
    report["flash_probs_build"] = probs_build_report(checks, libs["flash_probs"])
    report["flash_f32_build"] = flash_f32_build_report(checks)
    report["wide_build"] = wide_build_report(checks, libs)
    report["bwd_wide_build"] = bwd_wide_build_report(checks, libs)

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
    per_step_chunked = {rid: list(eng.results[rid]) for rid in range(8)}
    check_graph_replay(eng, checks, "serve_chunked")
    report["chunked_prefill_profile"] = profile_chunked_prefill(eng, cfg, args.seed)
    print(json.dumps({"chunked_prefill_profile": report["chunked_prefill_profile"]}), flush=True)
    checks.raise_on_failure("chunked serving")
    mark("serve_chunked")

    # 11 (here, beside the chunked engine and its params): serving and
    # training on a mesh, the shard-shape kernels, dp = 2 in two processes
    mesh_gen = torch.Generator(device="cuda").manual_seed(args.seed + 11)
    report["serve_mesh"] = serve_mesh(mesh_gen, Timer(), params, cfg, ecfg, eng,
                                      per_step_chunked, args.seed, checks, paths)
    del eng
    torch.cuda.empty_cache()
    mark("serve_mesh")
    phase_s["serve_pp_inside_serve_mesh"] = report["serve_mesh"]["pp"]["phase_s"]
    phase_s["serve_cp_inside_serve_mesh"] = report["serve_mesh"]["cp"]["phase_s"]

    # the engine's features: windows, sampling, speculative verify, prefixes
    report["serve_features"] = serve_features(params, cfg, ecfg, args.seed, checks, paths,
                                              per_step_chunked)
    checks.raise_on_failure("serving features")
    mark("serve_features")

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
        if prof["eager_on_static_buffers"]:  # the same with the eager step's device time
            prof["busy_share_eager_device_ms"] = (
                prof["eager_on_static_buffers"]["device_ms_per_step"]
                / bucketed["decode_step_ms"]["p50"])
    report["decode_profile"] = prof
    print(json.dumps({"decode_profile": prof}), flush=True)
    check_graph_replay(eng, checks, "serve_bucketed")
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

    # 6. the MoE family: Mixtral-8x7B geometry served, saved and resumed, trained
    report["serve_moe"] = serve_moe(gen, checks, paths, args.seed)
    mark("serve_moe")
    phase_s["serve_mesh_ep_inside_serve_moe"] = report["serve_moe"]["phase12_s"]

    # 7. fp16 and f32: the new instantiations against their plain versions,
    # the refusals that stay, the api's calls over fp16 and f32 caches, then
    # Llama-8B served in fp16 and in f32
    dtype_rows = check_dtype_kernels(gen, Timer(), checks, cfg)
    measured.update(dtype_rows)
    report["dtype_kernels"] = dtype_rows
    print(json.dumps({"dtype_kernels": dtype_rows}), flush=True)
    check_refusals(checks)
    cases, paths["api_dtypes"] = drive("api_dtypes", lambda: api_dtype_path(gen, cfg))
    check_api_dtype_outputs(checks, cases)
    del cases
    checks.raise_on_failure("fp16 and f32 kernels")
    torch.cuda.empty_cache()
    mark("dtype_kernels")

    # 8. the dense flash family in f32: K7, K8 and K9-K11 against their plain
    # versions in f64 and f32, f32 training (8 layers), the api's f32 dense
    # calls; the bucketed f32 engine serves below, beside serve_f32
    flash_f32_rows, report["train_f32"] = f32_flash_phase(gen, Timer(), checks, cfg, paths,
                                                          args.seed)
    measured.update(flash_f32_rows)
    report["flash_f32_kernels"] = flash_f32_rows
    mark("flash_f32")
    report["serving_dtypes"] = serving_dtype_paths(gen, cfg, checks, paths, args.seed)
    mark("serving_dtypes")

    # 9. K1 and K7 at every head dim from 16 to 256 against their plain
    # versions, the rows at d = 96 and 256 timed; then Phi-3-mini widths
    # (head dim 96) served chunked and bucketed
    head_dim_rows = head_dims_phase(gen, Timer(), checks)
    measured.update(head_dim_rows)
    report["head_dim_kernels"] = head_dim_rows
    print(json.dumps({"head_dim_kernels": head_dim_rows}), flush=True)
    checks.raise_on_failure("head dims")
    torch.cuda.empty_cache()
    mark("head_dims")
    report["serve_phi3"] = serve_phi3(gen, checks, paths, args.seed)
    mark("serve_phi3")

    # 10. K8 and K9-K11 at every head dim from 16 to 256 against their plain
    # versions, the rows at d = 96 and 256 timed; then Phi-3-mini widths
    # trained and the api's dense calls at its attention width
    check_bwd_head_dims(gen, checks)
    checks.raise_on_failure("backward head dims")
    bwd_rows = bwd_head_dim_rows(gen, Timer(), checks)
    measured.update(bwd_rows)
    report["bwd_head_dim_kernels"] = bwd_rows
    print(json.dumps({"bwd_head_dim_kernels": bwd_rows}), flush=True)
    checks.raise_on_failure("backward head-dim rows")
    torch.cuda.empty_cache()
    mark("bwd_head_dims")
    report["train_phi3"] = train_phi3(gen, checks, paths, args.seed)
    report["api_phi3"] = api_phi3(gen, checks, paths, args.seed)
    mark("train_phi3")

    # 15. the kernels line, the card, the result
    kernels = []
    for name, (source, replaces) in dict(KERNELS, **head_dim_kernels()).items():
        r = measured[name]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=(sum(p.get(name, 0) for p in paths.values()) if "@d" not in name else
                      sum(n for p in HEAD_DIM_PATHS.values() for k, n in p.items()
                          if k.startswith(name + "/"))),
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
    report["device_traces"] = DEVICE_TRACES
    print(json.dumps({"device_traces_short": [t for t in DEVICE_TRACES
                                              if t["recorded"] != t["launched"]]}), flush=True)
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
