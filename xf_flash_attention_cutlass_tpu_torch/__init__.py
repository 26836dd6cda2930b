"""PyTorch/CUDA port of xf_flash_attention_cutlass_tpu for NVIDIA Hopper.

The JAX package beside it is the reference; this package mirrors its module
layout and names. Plain tensor code is PyTorch; every Pallas kernel on the
ported path is a hand-written CUDA kernel for sm_90a (``csrc/``), built with
nvcc at first use and loaded with ctypes (``_build.py``).

Which implementation runs follows the device of the tensors: CUDA tensors
launch the kernels (or raise), CPU tensors run the plain PyTorch versions.
Entry points run on CUDA unless the caller passes ``device="cpu"``.

- ``api``    — the reference-style public wrappers below, (batch, seq,
               heads, dim) layout.
- ``ops``    — paged attention (K1), paged KV append (K2/K5), dense flash
               attention forward (K7), probabilities (K8) and backward
               (K9-K11), varlen and KV-cache entry points, split combine,
               rotary embedding.
- ``quant``  — per-token KV quantization; weight-only INT8/FP8 matmul (K3/K4).
- ``models`` — the Llama stack: forward, loss and the decode side.
- ``serve``  — page allocator and the continuous-batching DecodeEngine with
               chunked or bucketed prefill.
"""

__version__ = "0.1.0"

from xf_flash_attention_cutlass_tpu_torch.api import (  # noqa: F401,E402
    flash_attn_func,
    flash_attn_kvpacked_func,
    flash_attn_varlen_func,
    flash_attn_varlen_kvpacked_func,
    flash_attn_with_kvcache,
)
