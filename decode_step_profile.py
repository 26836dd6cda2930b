"""Device time and kernel launches of the serving decode step on one H100, for any tree.

    python3 decode_step_profile.py [TREE] [--steps N]

Builds chip_smoke.py's serving engine (Llama-8B at full width and depth,
random weights from seed 0, INT8 weights, FP8 paged KV, page 256, 8
requests, bucketed prefill), admits 8 requests of 256-token prompts from
seed 2 (chip_smoke.py's decode profile), then runs decode-only steps:
N steps under torch.profiler for the device time a step, the kernel
launches a step (every kernel's, counted in the trace) and K1's, K3/K4's
(the split-K reduction included) and the append kernel's kernels by name
with their calls,
then N steps more on the host clock (each ended
by the engine's own host sync) for their median. TREE (default: this
checkout) is the root of a checkout of the repository, so that a parent
tree unpacked beside this one is measured the same way in the same call.
Needs a CUDA device.
"""

import argparse
import json
import os
import statistics
import sys
import time


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("tree", nargs="?", default=os.path.dirname(os.path.abspath(__file__)))
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    os.chdir(tree)
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        sys.exit("decode_step_profile.py: no CUDA device")
    from xf_flash_attention_cutlass_tpu_torch.models.llama import (
        LlamaConfig,
        init_params,
        quantize_params,
    )
    from xf_flash_attention_cutlass_tpu_torch.serve.engine import DecodeEngine, EngineConfig

    cfg = LlamaConfig.llama8b()
    params = quantize_params(init_params(torch.Generator(device="cuda").manual_seed(0), cfg))
    eng = DecodeEngine(params, cfg, EngineConfig(kv_quant="fp8_e4m3", page_size=256,
                                                 num_pages=256, max_seq=4096, max_batch=8))
    rng = np.random.default_rng(2)
    n = eng.ecfg.max_batch
    for i in range(n):  # enough new tokens for the warm step and both windows
        eng.add_request(i, rng.integers(0, cfg.vocab_size, 256).tolist(), 2 * args.steps + 4)
    eng.step()  # admit and prefill every request, and the first decode
    eng.step()  # warm
    if len(eng.active) != n:
        sys.exit(f"decode_step_profile.py: {len(eng.active)} of {n} requests active")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(0.05)  # the trace records no kernel in its first moments
        for _ in range(args.steps):
            eng.step()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    total_us = sum(e.self_device_time_total for e in kernels)
    if total_us <= 0:
        sys.exit("decode_step_profile.py: the trace holds no device time")
    host_ms = []
    for _ in range(args.steps):
        t0 = time.perf_counter()
        eng.step()
        host_ms.append(1e3 * (time.perf_counter() - t0))

    def by_name(pick):
        return [dict(kernel=e.key[:90], ms_per_step=e.self_device_time_total / 1e3 / args.steps,
                     calls_per_step=e.count / args.steps) for e in kernels if pick(e.key)]

    k1 = by_name(lambda k: "paged_" in k and "append" not in k)
    k3 = by_name(lambda k: "qmm_" in k)
    append = by_name(lambda k: "paged_append_kernel" in k)
    print(json.dumps({"decode_step_profile": dict(
        tree=tree, steps=args.steps, device_ms_per_step=total_us / 1e3 / args.steps,
        launches_per_step=sum(e.count for e in kernels) / args.steps,
        host_ms_p50=statistics.median(host_ms), host_ms=host_ms, k1_kernels=k1,
        k3_kernels=k3, append_kernels=append, device=torch.cuda.get_device_name(0))}), flush=True)


if __name__ == "__main__":
    main()
