"""LLaMA-style decoder stack: the config, random init, norms, projections,
the MLP, the full causal ``forward`` and the training ``loss_fn``, plus
INT8 weight quantization and the conversion of the JAX package's parameters.

Parameters are a plain dict with the JAX package's structure: ``embed``
(vocab, dim), ``layers`` holding (L, ...) stacks, ``final_norm`` and
``lm_head`` (dim, vocab). A quantized projection is a ``(w_q, scale)`` tuple,
a decode-packed one ``(w, None)``; ``layer_view`` adds the layer index so the
matmul reads one layer of a stack in place.

``forward`` runs attention through the differentiable dense flash attention
(``ops/flash.py``: K7 forward, K9/K10 backward on CUDA, or K11 with
``fused=True``), so ``loss_fn`` has a gradient through the kernels; padded
batches are masked with ``kv_lens`` (the same mask the JAX package builds
from segment ids).

Tensor parallelism (``parallel/tp.py``): ``attn_qkv``, ``attention_block``
and ``mlp_block`` take a ``group`` (the JAX package's ``axis_name``), a
``torch.distributed`` process group over which the heads and the ffn dim
are sharded. Megatron's f and g mark the sharded regions: ``tp_region_in``
(identity forward, all-reduce backward) where a replicated activation
enters one, ``tp_region_out`` (all-reduce forward, identity backward) where
its partial sums leave; ``gather_vocab`` and ``scale_grad`` join a
vocab-sharded lm_head's logits.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from xf_flash_attention_cutlass_tpu_torch.ops.flash import flash_attention
from xf_flash_attention_cutlass_tpu_torch.ops.rotary import apply_rotary, rotary_frequencies
from xf_flash_attention_cutlass_tpu_torch.quant.linear import quantize_weight, quantized_matmul
from xf_flash_attention_cutlass_tpu_torch.utils import acc_dtype
from xf_flash_attention_cutlass_tpu_torch.utils.collectives import (
    all_gather,
    all_reduce_,
    reduce_scatter,
)

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


# ---- Megatron-style TP region markers (parallel/tp.py) -------------------


class _RegionIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, ct):
        return all_reduce_(ct.clone(), ctx.group), None


class _RegionOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, ct):
        return ct, None


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, s):
        ctx.s = s
        return x.view_as(x)

    @staticmethod
    def backward(ctx, ct):
        return ct * ctx.s, None


class _GatherLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_gather(x, group, dim=-1)

    @staticmethod
    def backward(ctx, ct):
        return reduce_scatter(ct, ctx.group, dim=-1), None


def _differentiable(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def tp_region_in(x: torch.Tensor, group) -> torch.Tensor:
    """f: identity forward, all-reduce backward. Placed where a replicated
    activation enters head- or ffn-sharded compute, so that upstream (norms,
    the embedding) receives the full, replicated cotangent."""
    return _RegionIn.apply(x, group) if _differentiable(x) else x


def tp_region_out(x: torch.Tensor, group) -> torch.Tensor:
    """g: all-reduce forward, identity backward: the sharded region's
    partial sums reduced. Without a gradient the sum is taken in place."""
    return _RegionOut.apply(x, group) if _differentiable(x) else all_reduce_(x, group)


def scale_grad(x: torch.Tensor, s: float) -> torch.Tensor:
    """Identity forward, cotangent scaled by s. Used after the vocab
    all-gather: the loss is computed redundantly on every tp rank, so the
    gather's transpose (a reduce-scatter) would overcount the cotangent
    tp-fold."""
    return _ScaleGrad.apply(x, s) if _differentiable(x) else x


def gather_vocab(logits_local: torch.Tensor, group) -> torch.Tensor:
    """A vocab-sharded lm_head's logits (..., V / tp) gathered to (..., V)
    on every rank; the backward reduce-scatters the cotangent, scaled by
    1 / tp (scale_grad)."""
    if not _differentiable(logits_local):
        return all_gather(logits_local, group, dim=-1)
    return scale_grad(_GatherLast.apply(logits_local, group), 1.0 / dist.get_world_size(group))


def layer_view(layers: Dict[str, Any], l: int) -> Dict[str, Any]:
    """One layer's params: plain stacks (or lists of per-layer views)
    indexed, projection tuples given the layer index so the matmul reads the
    stack in place."""
    out = {}
    for name, v in layers.items():
        out[name] = (v[0], v[1], l) if isinstance(v, tuple) else v[l]
    return out


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.to(acc_dtype(x.dtype))
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


def mlp_block(layer: Dict[str, Any], x: torch.Tensor, cfg: LlamaConfig,
              group=None) -> torch.Tensor:
    """The SwiGLU MLP with its residual; under a tp `group` the ffn dim is
    sharded and the down projection's partial sums are all-reduced."""
    h = rms_norm(x, layer["mlp_norm"], cfg.rms_eps)
    if group is not None:
        h = tp_region_in(h, group)
    gate = _proj(h, layer["w_gate"])
    up = _proj(h, layer["w_up"])
    partial = _proj(F.silu(gate) * up, layer["w_down"])
    if group is not None:
        partial = tp_region_out(partial, group)
    return x + partial


def attn_qkv(layer: Dict[str, Any], x: torch.Tensor, cfg: LlamaConfig, cos, sin, positions,
             group=None):
    """norm -> q/k/v projections -> rotary, (b, s, heads, head_dim) each;
    shared by the full forward and the engine's prefill and decode. Under a
    tp `group`, cfg holds the local head counts (parallel/tp.py _local_cfg)."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    h = rms_norm(x, layer["attn_norm"], cfg.rms_eps)
    if group is not None:
        h = tp_region_in(h, group)
    q = _proj(h, layer["wq"]).reshape(b, s, cfg.n_heads, hd)
    k = _proj(h, layer["wk"]).reshape(b, s, cfg.n_kv_heads, hd)
    v = _proj(h, layer["wv"]).reshape(b, s, cfg.n_kv_heads, hd)
    q = apply_rotary(q, cos, sin, positions, cfg.rotary_interleaved)
    k = apply_rotary(k, cos, sin, positions, cfg.rotary_interleaved)
    return q, k, v


def attention_block(
    layer: Dict[str, Any],
    x: torch.Tensor,  # (b, s, dim)
    cfg: LlamaConfig,
    cos: torch.Tensor,
    sin: torch.Tensor,
    positions: torch.Tensor,  # (b, s)
    kv_lens: Optional[torch.Tensor] = None,  # (b,) mask for padded batches
    fused: Optional[bool] = None,  # the attention backward's schedule (ops/flash_bwd.py)
    group=None,  # tp group: local heads, the O projection's partial sums all-reduced
) -> torch.Tensor:
    b, s, _ = x.shape
    q, k, v = attn_qkv(layer, x, cfg, cos, sin, positions, group)
    # padded batches: keys at or past kv_lens are masked. The JAX package
    # builds the same mask from segment ids, because its custom VJP takes no
    # kv_lens; here the kernels take kv_lens and skip the masked key tiles.
    o, _ = flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                           causal=True, kv_lens=kv_lens, fused=fused)
    o = o.transpose(1, 2).reshape(b, s, cfg.n_heads * cfg.head_dim)
    partial = _proj(o, layer["wo"])
    if group is not None:
        partial = tp_region_out(partial, group)
    return x + partial


def forward(
    params: Dict[str, Any],
    tokens: torch.Tensor,  # (b, s) int
    cfg: LlamaConfig,
    positions: Optional[torch.Tensor] = None,  # (b, s) int
    kv_lens: Optional[torch.Tensor] = None,  # (b,) mask for padded batches
    fused: Optional[bool] = None,  # the attention backward's schedule (ops/flash_bwd.py)
) -> torch.Tensor:
    """Full causal forward; returns logits (b, s, vocab) f32."""
    b, s = tokens.shape
    x = params["embed"][tokens]
    if positions is None:
        positions = torch.arange(s, device=tokens.device)[None].expand(b, s)
    cos, sin = rotary_frequencies(cfg.head_dim, cfg.max_seq_len, cfg.rope_base,
                                  device=x.device)
    # every plain (L, ...) stack split once into per-layer views: the backward
    # of one unbind stacks the layers' gradients in one copy, where indexing
    # the stack in each layer costs a zero-filled stack-sized gradient a layer
    layers = {n: v if isinstance(v, tuple) else list(v.unbind(0))
              for n, v in params["layers"].items()}
    for l in range(cfg.n_layers):
        layer = layer_view(layers, l)
        x = attention_block(layer, x, cfg, cos, sin, positions, kv_lens, fused)
        x = mlp_block(layer, x, cfg)
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    return _proj(x, params["lm_head"]).float()


def loss_fn(params: Dict[str, Any], tokens: torch.Tensor, cfg: LlamaConfig,
            fused: Optional[bool] = None) -> torch.Tensor:
    """Next-token cross entropy, the mean over (b, s - 1) positions."""
    logits = forward(params, tokens[:, :-1], cfg, fused=fused)
    targets = tokens[:, 1:].long()
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, targets[..., None])[..., 0].mean()


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
