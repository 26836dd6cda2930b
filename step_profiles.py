"""Device time of every main path's step on one H100, for any tree, by one harness.

    python3 step_profiles.py [TREE] [--seed N]

Runs this checkout's chip_smoke.py harness on the package of TREE (default:
this checkout), each step under a profiler trace (`profiled`): one training
step (Llama-8B widths, 32 layers, bf16, after a warm one), the chunked
prefill of the 8 serving prompts (`profile_chunked_prefill`), one bucketed
admission of the largest of them (`profile_admission`), a decode window of
8 requests (`profile_decode`), and each step of the `api` path, warm
(`time_api_steps`). It prints one JSON line: each step's device ms and
launches, with its kernel groups' device ms (K1's routes, K3, K7, the
append kernel: `append`), and K8's, K1's and the layout copy's device ms
in the api steps.
A parent tree unpacked beside this one is measured by the same code in the
same call, which chip_smoke.py's own profiles of two trees are not when
the harness changed between them. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import os
import sys
import time


def main():
    here = os.path.dirname(os.path.abspath(__file__))
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("tree", nargs="?", default=here)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    os.chdir(tree)
    import torch

    if not torch.cuda.is_available():
        sys.exit("step_profiles.py: no CUDA device")
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(here, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from xf_flash_attention_cutlass_tpu_torch import _build
    from xf_flash_attention_cutlass_tpu_torch.models.llama import (
        LlamaConfig,
        init_params,
        quantize_params,
    )
    from xf_flash_attention_cutlass_tpu_torch.serve.engine import DecodeEngine, EngineConfig

    t0 = time.perf_counter()
    _build.build_all()
    cfg = LlamaConfig.llama8b()
    gen = torch.Generator(device="cuda").manual_seed(args.seed)

    def step(prof):
        if prof is None:
            return None
        return dict(device_ms=prof["device_ms_per_step"], launches=prof["launches_per_step"],
                    **prof.get("groups_ms_per_step", {}))

    out = dict(tree=tree)
    _, training = cs.train(gen, cfg, args.seed, steps=1)
    out["train"] = step(training["profile"])
    params = quantize_params(init_params(gen, cfg))
    ecfg = EngineConfig(kv_quant="fp8_e4m3", page_size=256, num_pages=256, max_seq=4096,
                        max_batch=8, prefill_chunk=256)
    eng = DecodeEngine(params, cfg, ecfg)
    eng.add_request(-1, list(range(300)), 2)  # warm-up request
    eng.run()
    out["chunked_prefill"] = step(cs.profile_chunked_prefill(eng, cfg, args.seed))
    del eng
    eng = DecodeEngine(params, cfg, dataclasses.replace(ecfg, prefill_chunk=None))
    out["admission"] = step(cs.profile_admission(eng, cfg, args.seed))
    out["decode"] = step(cs.profile_decode(eng, cfg, args.seed))
    del eng, params
    torch.cuda.empty_cache()
    _, _, calls, copies = cs.api_path(gen, cfg, args.seed)
    out["api"] = {n: dict(device_ms=r["device_ms"], k8=r["k8_device_ms"], k1=r["k1_device_ms"],
                          layout_copy=r.get("layout_copy_device_ms"))
                  for n, r in cs.time_api_steps(calls, copies).items()}
    out["seconds"] = time.perf_counter() - t0
    out["device"] = cs.nvidia_smi()
    print(json.dumps({"step_profiles": out}), flush=True)


if __name__ == "__main__":
    main()
