"""Staged bring-up and timing of K10/K11 (the dK/dV backward and its fused
one-pass form) on one H100.

    python3 flash_bwd_bringup.py [--seed N]

Builds csrc/flash_bwd.cu alone, prints its `flash_bwd_build` line
(registers, spills, SASS counts and any ptxas line saying wgmma was
serialized), then checks the kernels stage by stage with chip_smoke.py's
checks under the 3x rule, both routes (K9 + K10, and K11) each time, and
prints the failed checks of each stage:
(a) option-free shapes, small then the training shape; (b) the options'
instantiation (ALiBi with dropout, explicit positions with per-row ALiBi);
(c) K10 twice bit for bit, K11's dK/dV against K10's and its dQ against
K9's; (d) the backward tiling cases and the model's (b, s, h, d) views. Last,
it times K9, K10 and K11 at the training shape and with ALiBi and dropout
at the api path's shape. A descriptor or layout mistake shows as wrong
numbers, not a fault, so a change to the kernels is run here before
chip_smoke.py. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

import torch

import chip_smoke as cs
from xf_flash_attention_cutlass_tpu_torch import _build
from xf_flash_attention_cutlass_tpu_torch.models.llama import LlamaConfig
from xf_flash_attention_cutlass_tpu_torch.ops.flash_bwd import FlashBwdLaunch

SMALL = [("small_64x64", 1, 2, 2, 64, 64, 128, dict()),
         ("small_causal_128", 1, 4, 2, 128, 128, 128, dict(causal=True)),
         ("small_d64_causal", 1, 4, 1, 192, 192, 64, dict(causal=True))]


def stage(checks, name, fn):
    """Run fn, then print the failures of each route among the checks it added."""
    n0 = len(checks.cases)
    fn()
    new = checks.cases[n0:]
    failed = [c["case"] for c in new if not c["ok"]]
    print(json.dumps({"stage": name, "cases": len(new), "failed": failed}), flush=True)
    return not failed


def time_api(timer, cfg, gen):
    """K9, K10 and K11 with causal ALiBi and dropout 0.1 at the api path's
    dense shape (b = 1, 2048 tokens, Llama-8B heads)."""
    from xf_flash_attention_cutlass_tpu_torch.ops.flash_fwd import flash_fwd_ref
    from xf_flash_attention_cutlass_tpu_torch.utils.testing import alibi_slopes_ref

    h, h_k, d, s = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cs.API_S
    q, k, v, do = (torch.randn(sh, generator=gen, device="cuda").bfloat16()
                   for sh in ((1, h, s, d), (1, h_k, s, d), (1, h_k, s, d), (1, h, s, d)))
    slopes = torch.from_numpy(alibi_slopes_ref(h)).cuda()
    kw = dict(causal=True, alibi_slopes=slopes, dropout_p=cs.API_P, dropout_seed=cs.API_SEED)
    o, lse = flash_fwd_ref(q, k, v, **kw)
    run = FlashBwdLaunch(q, k, v, o, lse, do, scale=1.0 / math.sqrt(d), causal=True,
                         window=(-1, -1), softcap=0.0, kv_lens=None, q_segment_ids=None,
                         kv_segment_ids=None, alibi_slopes=slopes, dropout_p=cs.API_P,
                         dropout_seed=cs.API_SEED)
    return dict(dq_ms=timer.ms(run.dq), dkv_ms=timer.ms(run.dkv), fused_ms=timer.ms(run.fused))


def bring_up(seed, cfg):
    t0 = time.perf_counter()
    lib = _build.build_all()["flash_bwd"]
    print(json.dumps({"build_s": time.perf_counter() - t0}), flush=True)
    checks = cs.Checks()
    cs.flash_bwd_build_report(checks, lib)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    h, h_k, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    train = {}

    def plain():
        for name, *shape, opts in SMALL:
            cs.check_flash_bwd(gen, checks, name, *shape, opts)
        train["x"] = cs.check_flash_bwd(gen, checks, "train_s1024", 1, h, h_k, 1024, 1024, d,
                                        dict(causal=True))

    def repeat():
        tensors, kw, _ = train["x"]
        cs.check_flash_bwd_repeat(checks, tensors, kw, "train_s1024")

    def tiling():
        for name, *shape, opts in cs.FLASH_BWD_TILING:
            cs.check_flash_bwd(gen, checks, f"tiling.{name}", *shape, opts)
        cs.check_flash_bwd_views(gen, checks, cfg)

    ok = True
    for name, fn in (("a_option_free", plain),
                     ("b_options", lambda: cs.check_flash_bwd_options(gen, checks, cfg)),
                     ("c_repeat_and_fused", repeat), ("d_tiling_and_views", tiling)):
        ok = stage(checks, name, fn) and ok
    timer = cs.Timer()
    tensors, kw, worst = train["x"]
    timed = cs.time_flash_bwd(timer, tensors, kw, worst)
    print(json.dumps({"train_s1024": {
        n: dict(ms=r["ms"], ms_general=r["ms_general"], bound_ms=r["bound"][0],
                library_ms=r["library_ms"]) for n, r in timed.items()},
        "api_s2048_alibi_dropout": time_api(timer, cfg, gen)}), flush=True)
    return ok


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("flash_bwd_bringup.py: no CUDA device")
    _build.SOURCES = ("flash_bwd",)
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 oracles in full f32
    cfg = LlamaConfig.llama8b()
    ok = bring_up(args.seed, cfg)
    print(cs.nvidia_smi(), flush=True)
    if not ok:
        sys.exit("flash_bwd bring-up: some checks failed")


if __name__ == "__main__":
    main()
