"""Device time of a chunked prefill on one H100, by kernel, for any tree.

    python3 chunked_prefill_profile.py [TREE]

Serves chip_smoke.py's 8 serving prompts (seed 0: 5119 tokens, Llama-8B at
full width and depth, random weights, INT8 weights, FP8 paged KV, 256-token
chunks) with one new token each, once to warm up and once under a profiler
trace (chip_smoke.py's `profiled`), and prints the device time of the
prefill, K1's on each of its routes (the Hopper chunk kernel
`paged_wgmma_kernel`, the decode kernel `paged_decode_kernel` and its
combine `paged_combine_kernel`, the WMMA kernel `paged_attention_kernel`;
a tree without a kernel shows 0 for it), K3's, and K1's kernels with their
calls. TREE (default: this checkout) is the root of a checkout of the
repository, so that a parent tree unpacked beside this one is measured the
same way in the same call. Needs a CUDA device.
"""

import json
import os
import sys


def main():
    tree = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else os.path.dirname(__file__))
    sys.path.insert(0, tree)
    os.chdir(tree)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("chunked_prefill_profile.py: no CUDA device")
    import chip_smoke as cs
    from xf_flash_attention_cutlass_tpu_torch.models.llama import (
        LlamaConfig,
        init_params,
        quantize_params,
    )
    from xf_flash_attention_cutlass_tpu_torch.serve.engine import DecodeEngine, EngineConfig

    cfg = LlamaConfig.llama8b()
    params = quantize_params(init_params(torch.Generator(device="cuda").manual_seed(0), cfg))
    eng = DecodeEngine(params, cfg, EngineConfig(kv_quant="fp8_e4m3", page_size=256,
                                                 num_pages=256, max_seq=4096, max_batch=8,
                                                 prefill_chunk=256))
    rng = np.random.default_rng(0)  # chip_smoke.py serve()'s prompts
    lens = rng.integers(200, 1501, 8)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist() for n in lens]
    n_added = [0]

    def run():
        for prompt in prompts:
            eng.add_request(5000 + n_added[0], prompt, 1)
            n_added[0] += 1
        eng.run()

    run()  # warm
    prof = cs.profiled(run, groups=dict(k1_decode="paged_decode_kernel",
                                        k1_combine="paged_combine_kernel",
                                        k1_wgmma="paged_wgmma_kernel",
                                        k1_wmma="paged_attention_kernel", k3="qmm"))
    if prof is None:
        sys.exit("chunked_prefill_profile.py: the trace holds no device time")
    k1 = [t for t in prof["top"] if "paged_" in t["kernel"] and "append" not in t["kernel"]]
    print(json.dumps({"chunked_prefill_profile": dict(
        tree=tree, prompt_tokens=int(lens.sum()), device_ms=prof["device_ms_per_step"],
        groups=prof["groups_ms_per_step"], k1_kernels=k1)}), flush=True)


if __name__ == "__main__":
    main()
