"""Staged bring-up and timing of K8, the probability plane, on one H100.

    python3 probs_bringup.py [TREE] [--seed N] [--stages a,b,...]

Builds csrc/flash_fwd.cu (K7 gives the LSE) and csrc/flash_probs.cu alone,
then runs the stages that --stages names (all by default), each printing
its failed checks:
  build   the `flash_probs_build` line of chip_smoke.py: registers and
          spill bytes of each instantiation, and the HGMMA (wgmma),
          UTMALDG (TMA load), UTMASTG (TMA store) and HMMA (mma.sync)
          counts of its SASS;
  checks  K8 at chip_smoke.py's PROBS_CASES and at the api path's dense
          shape (1, 32, 2048, 2048, causal, ALiBi, dropout 0.1) against its
          plain version (check_probs: entry by entry, sign bits, row sums);
  shares  K8 at the api path's dense shape in five variants, on the Timer
          and on device (chip_smoke.py's probs_shares: dropout 0, no ALiBi,
          non-causal, every tile dead), and on the api path's packed plane.
TREE (default: this checkout) is the root of a checkout whose package is
measured with this checkout's chip_smoke.py, so that a parent tree
unpacked beside this one is measured the same way in the same call (its
`build` stage is this tree's report: run the parent without it). A
descriptor or layout mistake shows as wrong numbers, not a fault, so a
change to K8 is run here before chip_smoke.py. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time

STAGES = ("build", "checks", "shares")
HERE = os.path.dirname(os.path.abspath(__file__))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("tree", nargs="?", default=HERE)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--stages", default=",".join(STAGES))
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    os.chdir(tree)
    import torch

    if not torch.cuda.is_available():
        sys.exit("probs_bringup.py: no CUDA device")
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from xf_flash_attention_cutlass_tpu_torch import _build
    from xf_flash_attention_cutlass_tpu_torch.models.llama import LlamaConfig
    from xf_flash_attention_cutlass_tpu_torch.ops.flash_fwd import flash_fwd
    from xf_flash_attention_cutlass_tpu_torch.utils.testing import alibi_slopes_ref

    stages = args.stages.split(",")
    _build.SOURCES = ("flash_fwd", "flash_probs")
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 oracles in full f32
    cfg = LlamaConfig.llama8b()
    t0 = time.perf_counter()
    lib = _build.build_all()["flash_probs"]
    print(json.dumps({"tree": tree, "build_s": time.perf_counter() - t0}), flush=True)
    checks = cs.Checks()
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    timer = cs.Timer()

    def stage(name, fn):
        n0 = len(checks.cases)
        out = fn()
        failed = [c["case"] for c in checks.cases[n0:] if not c["ok"]]
        print(json.dumps({"stage": name, "cases": len(checks.cases) - n0, "failed": failed}),
              flush=True)
        return out

    def api_shape():
        h, h_k, d, s = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cs.API_S
        q = torch.randn((1, h, s, d), generator=gen, device="cuda").bfloat16()
        k = torch.randn((1, h_k, s, d), generator=gen, device="cuda").bfloat16()
        kw = dict(causal=True, alibi_slopes=torch.from_numpy(alibi_slopes_ref(h)).cuda(),
                  dropout_p=cs.API_P, dropout_seed=cs.API_SEED)
        _, lse = flash_fwd(q, k, k, **kw)
        cs.check_probs(checks, "api_s2048_alibi_dropout", q, k, lse, kw)

    if "build" in stages:
        stage("a_build", lambda: cs.probs_build_report(checks, lib))
    if "checks" in stages:
        stage("b_cases", lambda: cs.check_probs_cases(gen, checks))
        stage("c_api_shape", api_shape)
    if "shares" in stages:
        shares = cs.probs_shares(gen, timer, cfg, cs.serving_prompt_lens(args.seed))
        print(json.dumps({"probs_shares": shares}), flush=True)
    print(cs.nvidia_smi(), flush=True)
    bad = [c["case"] for c in checks.cases if not c["ok"]]
    if bad:
        sys.exit(f"probs bring-up: {len(bad)} check(s) failed: {bad}")


if __name__ == "__main__":
    main()
