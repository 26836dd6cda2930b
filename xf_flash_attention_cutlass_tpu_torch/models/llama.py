"""LLaMA-style decoder stack, decode side: the config, random init, norms,
projections and the MLP the serving engine runs, plus INT8 weight
quantization and the conversion of the JAX package's parameters.

Parameters are a plain dict with the JAX package's structure: ``embed``
(vocab, dim), ``layers`` holding (L, ...) stacks, ``final_norm`` and
``lm_head`` (dim, vocab). A quantized projection is a ``(w_q, scale)`` tuple,
a decode-packed one ``(w, None)``; the engine adds the layer index to read
one layer of a stack in place.

The full causal ``forward`` waits for the dense flash kernel (K7); the
engine serves prefill through its chunked paged path instead.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from xf_flash_attention_cutlass_tpu_torch.quant.linear import quantize_weight, quantized_matmul

PROJ_NAMES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    ffn_dim: int = 14336
    max_seq_len: int = 8192
    rope_base: float = 500000.0
    rms_eps: float = 1e-5
    rotary_interleaved: bool = False  # NeoX-style halves (llama convention)
    head_dim_override: Optional[int] = None

    @property
    def head_dim(self) -> int:
        if self.head_dim_override is not None:
            return self.head_dim_override
        return self.dim // self.n_heads

    @classmethod
    def llama8b(cls) -> "LlamaConfig":
        return cls(
            vocab_size=128256, dim=4096, n_layers=32, n_heads=32,
            n_kv_heads=8, ffn_dim=14336,
        )

    @classmethod
    def tiny(cls) -> "LlamaConfig":
        """Small config for compile checks and CPU tests."""
        return cls(
            vocab_size=512, dim=256, n_layers=2, n_heads=4, n_kv_heads=2,
            ffn_dim=512, max_seq_len=1024,
        )


def init_params(generator: torch.Generator, cfg: LlamaConfig,
                dtype=torch.bfloat16) -> Dict[str, Any]:
    """Random parameters (scaled gaussians) on the generator's device,
    made one layer at a time so that the float32 temporaries stay small."""
    dev = generator.device
    d, hd = cfg.dim, cfg.head_dim
    shapes = dict(
        wq=(d, cfg.n_heads * hd), wk=(d, cfg.n_kv_heads * hd),
        wv=(d, cfg.n_kv_heads * hd), wo=(cfg.n_heads * hd, d),
        w_gate=(d, cfg.ffn_dim), w_up=(d, cfg.ffn_dim), w_down=(cfg.ffn_dim, d),
    )

    def dense(din, dout):
        w = torch.randn((din, dout), generator=generator, device=dev)
        return (w / math.sqrt(din)).to(dtype)

    layers = {
        n: torch.empty((cfg.n_layers, *s), dtype=dtype, device=dev) for n, s in shapes.items()
    }
    for li in range(cfg.n_layers):
        for n, (din, dout) in shapes.items():
            layers[n][li] = dense(din, dout)
    layers["attn_norm"] = torch.ones((cfg.n_layers, d), dtype=dtype, device=dev)
    layers["mlp_norm"] = torch.ones((cfg.n_layers, d), dtype=dtype, device=dev)
    embed = torch.randn((cfg.vocab_size, d), generator=generator, device=dev) * 0.02
    return dict(
        embed=embed.to(dtype),
        layers=layers,
        final_norm=torch.ones((d,), dtype=dtype, device=dev),
        lm_head=dense(d, cfg.vocab_size),
    )


def layer_view(layers: Dict[str, Any], l: int) -> Dict[str, Any]:
    """One layer's params: plain stacks sliced (views), projection tuples
    given the layer index so the matmul reads the stack in place."""
    out = {}
    for name, v in layers.items():
        out[name] = (v[0], v[1], l) if isinstance(v, tuple) else v[l]
    return out


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    # cast to x's dtype BEFORE the weight multiply, as the JAX package does
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


def _proj(x: torch.Tensor, w) -> torch.Tensor:
    """Dense or weight-quantized projection.

    w forms: plain tensor | (w_q, scale) | (w_q_stacked, scale_stacked,
    layer_idx). scale may be None for packed bf16 stacks."""
    if isinstance(w, tuple):
        if len(w) == 3:
            return quantized_matmul(x, w[0], w[1], layer_idx=w[2])
        return quantized_matmul(x, w[0], w[1])
    return x @ w


def mlp_block(layer: Dict[str, Any], x: torch.Tensor, cfg: LlamaConfig) -> torch.Tensor:
    h = rms_norm(x, layer["mlp_norm"], cfg.rms_eps)
    gate = _proj(h, layer["w_gate"])
    up = _proj(h, layer["w_up"])
    return x + _proj(F.silu(gate) * up, layer["w_down"])


def pack_params_for_decode(params: Dict[str, Any]) -> Dict[str, Any]:
    """Wrap full-precision stacked projection weights as (w, None) tuples so
    the engine's layer loop reads them through the stacked matmul kernel.
    No data is copied; quantized (w_q, scale) tuples pass through."""
    out = dict(params)
    layers = dict(params["layers"])
    for name in PROJ_NAMES:
        w = layers.get(name)
        if w is not None and not isinstance(w, tuple) and w.dim() == 3:
            layers[name] = (w, None)
    out["layers"] = layers
    return out


def quantize_params(params: Dict[str, Any], quant_dtype=torch.int8) -> Dict[str, Any]:
    """INT8 weight-only quantization of all projection matrices (QKV/O, MLP)
    and the lm_head; norms and the embedding stay full precision. Each
    layer of a stack is quantized on its own, as the JAX package's vmap
    does."""
    out = dict(params)
    layers = dict(params["layers"])
    for name in PROJ_NAMES:
        w = layers[name]  # (L, din, dout)
        wq = torch.empty(w.shape, dtype=quant_dtype, device=w.device)
        s = torch.empty((w.shape[0], w.shape[2]), dtype=torch.float32, device=w.device)
        for li in range(w.shape[0]):
            wq[li], s[li] = quantize_weight(w[li], quant_dtype)
        layers[name] = (wq, s)
    out["layers"] = layers
    out["lm_head"] = quantize_weight(params["lm_head"], quant_dtype)
    return out


def _tensor_from_numpy(a: np.ndarray) -> torch.Tensor:
    """A numpy array (bf16 / fp8 as ml_dtypes arrays) as a torch tensor,
    bit for bit: 16- and 8-bit floats travel through integer views."""
    a = np.ascontiguousarray(a)
    name = a.dtype.name
    if name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    if name == "float8_e4m3fn":
        return torch.from_numpy(a.view(np.uint8).copy()).view(torch.float8_e4m3fn)
    return torch.from_numpy(a.copy())


def params_from_jax(tree) -> Any:
    """The JAX package's params, given as numpy arrays (dicts and tuples
    kept), as the port's params on the CPU: the same weights, bit for bit."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(params_from_jax(v) for v in tree)
    if tree is None:
        return None
    return _tensor_from_numpy(np.asarray(tree))
