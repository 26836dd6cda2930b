"""Mixtral-style sparse Mixture-of-Experts decoder: the JAX package's second
model family, on the same attention stack as the Llama one.

- The router and the top-k gating run in f32; each expert is the Llama
  SwiGLU MLP.
- Tokens reach their experts through the static GShard capacity dispatch: a
  (tokens, experts, capacity) dispatch/combine pair built from cumsum
  position counters, consumed by dense einsums. No shape depends on the
  routing and nothing reads a device value on the host, so the decode step
  that runs it can be captured in a CUDA graph. Assignments past an
  expert's capacity are dropped (their combine weight is zero), as in
  GShard; capacity_factor sets the drop rate.
- Quantized experts (``quantize_moe_params``) run through the weight-only
  matmul (K3, ``quant/linear.py``) one expert at a time, the expert axis
  flattened into the stack axis: layer l's expert e is ``l * E + e`` of a
  (L * E, d_in, d_out) view of the stack, read in place. Plain experts and
  the dispatch/combine einsums are torch.einsum, as the JAX package computes
  them outside any Pallas kernel.

Tensor parallelism: ``moe_mlp_block`` takes a tp ``group`` (the JAX
package's ``axis_name``); the experts' ffn dim is then sharded like the
dense MLP's (``parallel/tp.py``), the router and the dispatch are computed
on every rank, and the combined output's partial sums are all-reduced.
Expert parallelism: ``ep_fn`` (the JAX package's hook) replaces the expert
FFN over the dispatched (E, C, d) blocks; ``parallel/ep.py``'s
``ep_expert_apply`` sends each block to the rank that holds its expert and
back (an all-to-all each way).
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from xf_flash_attention_cutlass_tpu_torch.models.llama import (
    LlamaConfig,
    _proj,
    attention_block,
    layer_view,
    rms_norm,
    tp_region_in,
    tp_region_out,
)
from xf_flash_attention_cutlass_tpu_torch.ops.rotary import rotary_frequencies
from xf_flash_attention_cutlass_tpu_torch.quant.linear import quantize_weight, quantized_matmul

EXPERT_NAMES = ("w_gate", "w_up", "w_down")
ATTN_NAMES = ("wq", "wk", "wv", "wo")


@dataclasses.dataclass(frozen=True)
class MoEConfig(LlamaConfig):
    n_experts: int = 8
    top_k: int = 2
    # capacity per expert = ceil(tokens * top_k / n_experts * capacity_factor)
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01

    @classmethod
    def mixtral8x7b_geometry(cls) -> "MoEConfig":
        return cls(
            vocab_size=32000, dim=4096, n_layers=32, n_heads=32,
            n_kv_heads=8, ffn_dim=14336, n_experts=8, top_k=2,
        )

    @classmethod
    def tiny(cls) -> "MoEConfig":
        return cls(
            vocab_size=512, dim=128, n_layers=2, n_heads=4, n_kv_heads=2,
            ffn_dim=256, max_seq_len=512, n_experts=4, top_k=2,
        )


def expert_capacity(cfg: MoEConfig, n_tokens: int, ep: int = 1) -> int:
    """Static per-expert capacity of a dispatch over n_tokens (one shard's
    tokens under expert parallelism), rounded up to a multiple of 8 (at
    least 8), as the JAX package computes it. `ep` is accepted for the JAX
    signature and, as there, does not enter the count."""
    c = math.ceil(n_tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
    return max(8, -(-c // 8) * 8)


def _moe_layer(generator: torch.Generator, cfg: MoEConfig, dtype) -> Dict[str, torch.Tensor]:
    """One layer's random parameters (scaled gaussians, an f32 router)."""
    dev = generator.device
    d, hd, E, f = cfg.dim, cfg.head_dim, cfg.n_experts, cfg.ffn_dim

    def dense(shape, fan_in):
        w = torch.randn(shape, generator=generator, device=dev)
        return (w / math.sqrt(fan_in)).to(dtype)

    return dict(
        attn_norm=torch.ones((d,), dtype=dtype, device=dev),
        wq=dense((d, cfg.n_heads * hd), d),
        wk=dense((d, cfg.n_kv_heads * hd), d),
        wv=dense((d, cfg.n_kv_heads * hd), d),
        wo=dense((cfg.n_heads * hd, d), cfg.n_heads * hd),
        mlp_norm=torch.ones((d,), dtype=dtype, device=dev),
        # the router stays f32: gate logits are numerically sensitive
        router=torch.randn((d, E), generator=generator, device=dev) * 0.02,
        w_gate=dense((E, d, f), d),
        w_up=dense((E, d, f), d),
        w_down=dense((E, f, d), f),
    )


def _moe_outer(generator: torch.Generator, cfg: MoEConfig, dtype) -> Dict[str, torch.Tensor]:
    dev = generator.device
    embed = torch.randn((cfg.vocab_size, cfg.dim), generator=generator, device=dev) * 0.02
    lm_head = torch.randn((cfg.dim, cfg.vocab_size), generator=generator, device=dev)
    return dict(embed=embed.to(dtype), final_norm=torch.ones((cfg.dim,), dtype=dtype, device=dev),
                lm_head=(lm_head / math.sqrt(cfg.dim)).to(dtype))


def init_moe_params(generator: torch.Generator, cfg: MoEConfig,
                    dtype=torch.bfloat16) -> Dict[str, Any]:
    """Random parameters on the generator's device, in the JAX package's
    structure: (L, ...) stacks, experts (L, E, d_in, d_out), the router
    (L, d, E) f32. Made one layer at a time."""
    layers = [_moe_layer(generator, cfg, dtype) for _ in range(cfg.n_layers)]
    stacked = {k: torch.stack([layer[k] for layer in layers]) for k in layers[0]}
    return dict(_moe_outer(generator, cfg, dtype), layers=stacked)


def _quantize_stack(w: torch.Tensor, quant_dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each (d_in, d_out) matrix of a (..., d_in, d_out) stack quantized on
    its own: (w_q, scale (..., d_out))."""
    wq = torch.empty(w.shape, dtype=quant_dtype, device=w.device)
    s = torch.empty((*w.shape[:-2], w.shape[-1]), dtype=torch.float32, device=w.device)
    for idx in itertools.product(*map(range, w.shape[:-2])):
        wq[idx], s[idx] = quantize_weight(w[idx], quant_dtype)
    return wq, s


def init_moe_params_quantized(generator: torch.Generator, cfg: MoEConfig,
                              quant_dtype=torch.int8, dtype=torch.bfloat16) -> Dict[str, Any]:
    """``quantize_moe_params(init_moe_params(...))`` without ever holding the
    full-precision tree: each layer's weights are drawn in `dtype` and
    quantized into the preallocated stacks before the next layer is drawn
    (at Mixtral-8x7B geometry the bf16 tree is 93 GB, the int8 one 46 GB).
    The same draws as init_moe_params from the same generator state."""
    dev, L = generator.device, cfg.n_layers
    layers: Dict[str, Any] = {}
    for li in range(L):
        layer = _moe_layer(generator, cfg, dtype)
        for name, w in layer.items():
            if name in ATTN_NAMES or name in EXPERT_NAMES:
                if name not in layers:
                    layers[name] = (
                        torch.empty((L, *w.shape), dtype=quant_dtype, device=dev),
                        torch.empty((L, *w.shape[:-2], w.shape[-1]), dtype=torch.float32,
                                    device=dev))
                wq, s = _quantize_stack(w, quant_dtype)
                layers[name][0][li], layers[name][1][li] = wq, s
            else:
                if name not in layers:
                    layers[name] = torch.empty((L, *w.shape), dtype=w.dtype, device=dev)
                layers[name][li] = w
        del layer
    outer = _moe_outer(generator, cfg, dtype)
    outer["lm_head"] = quantize_weight(outer["lm_head"], quant_dtype)
    return dict(outer, layers=layers)


def top_k_dispatch(
    probs: torch.Tensor,  # (n, E) f32 router probabilities
    top_k: int,
    capacity: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """GShard-style static dispatch. Returns (dispatch, combine, aux):
    dispatch (n, E, C) 0/1, token n in slot c of expert e; combine (n, E, C)
    f32, dispatch weighted by the renormalized gate; aux the scalar
    load-balance loss E * sum_e (first-choice fraction_e * mean prob_e).

    Slots are seated in (choice, token) order: every first choice before
    any second choice. The top k come from a stable descending sort, so
    equal probabilities rank the lower expert first, as jax.lax.top_k does
    (torch.topk promises no order on ties). One-hots are comparisons with
    an arange, so nothing reads a device value on the host (the decode
    step runs this inside a CUDA graph)."""
    n, E = probs.shape
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = vals[:, :top_k], idx[:, :top_k]
    gate_vals = gate_vals / torch.clamp_min(gate_vals.sum(dim=-1, keepdim=True), 1e-9)
    experts = torch.arange(E, device=probs.device)
    slots = torch.arange(capacity, device=probs.device)
    dispatch = torch.zeros((n, E, capacity), dtype=probs.dtype, device=probs.device)
    combine = torch.zeros_like(dispatch)
    counts = torch.zeros((E,), dtype=torch.int64, device=probs.device)
    for j in range(top_k):
        oh = (gate_idx[:, j, None] == experts).to(torch.int64)  # (n, E)
        # the token's place in expert e's queue: an exclusive cumsum over
        # tokens, after the seats of earlier choice rounds
        pos = torch.cumsum(oh, dim=0) - oh + counts[None, :]
        counts = counts + oh.sum(dim=0)
        slot = (pos * oh).sum(dim=1)  # (n,); a slot past capacity matches no column
        d_j = oh.to(probs.dtype)[:, :, None] * (slot[:, None] == slots).to(probs.dtype)[:, None, :]
        dispatch = dispatch + d_j
        combine = combine + gate_vals[:, j, None, None] * d_j
    # the Switch-transformer load-balance loss, on the first choice
    first = (gate_idx[:, 0, None] == experts).to(probs.dtype)
    aux = E * torch.sum(first.mean(dim=0) * probs.mean(dim=0))
    return dispatch, combine, aux


def _expert_proj(x_e: torch.Tensor, w, e: int) -> torch.Tensor:
    """One expert's projection. w forms follow llama._proj: a plain
    (E, d_in, d_out) stack | (w_q (E, ...), scale (E, ...)) | the engine's
    layer view (w_q (L, E, ...), scale (L, E, ...), l), whose expert e is
    entry l * E + e of a (L * E, d_in, d_out) view of the stack (a view,
    never a copy: the matmul reads it in place)."""
    if isinstance(w, tuple):
        if len(w) == 3:
            wq, s, l = w
            L, E = wq.shape[0], wq.shape[1]
            return quantized_matmul(
                x_e, wq.view(L * E, *wq.shape[2:]),
                None if s is None else s.view(L * E, s.shape[2]), layer_idx=l * E + e)
        wq, s = w
        return quantized_matmul(x_e, wq, s, layer_idx=e)
    return x_e @ w[e]


def expert_ffn(w_gate, w_up, w_down, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU over (E, C, d) with per-expert weights (E, d, f) / (E, f, d).
    Quantized experts (tuples) take the fused-dequant matmul one expert at a
    time, so device memory sees one byte a weight."""
    if isinstance(w_gate, tuple):
        outs = []
        for e in range(x.shape[0]):
            g = _expert_proj(x[e], w_gate, e)
            u = _expert_proj(x[e], w_up, e)
            outs.append(_expert_proj(F.silu(g) * u, w_down, e))
        return torch.stack(outs)
    gate = torch.einsum("ecd,edf->ecf", x, w_gate)
    up = torch.einsum("ecd,edf->ecf", x, w_up)
    return torch.einsum("ecf,efd->ecd", F.silu(gate) * up, w_down)


def quantize_moe_params(params: Dict[str, Any], quant_dtype=torch.int8) -> Dict[str, Any]:
    """Weight-only quantization of the MoE family: the attention projections
    and the lm_head as llama.quantize_params does, and each expert matrix of
    the (L, E, d_in, d_out) stacks on its own: ((L, E, d_in, d_out) w_q,
    (L, E, d_out) f32 scales). The router, norms and embedding stay full
    precision."""
    out = dict(params)
    layers = dict(params["layers"])
    for name in ATTN_NAMES + EXPERT_NAMES:
        layers[name] = _quantize_stack(layers[name], quant_dtype)
    out["layers"] = layers
    out["lm_head"] = quantize_weight(params["lm_head"], quant_dtype)
    return out


def moe_mlp_block(
    layer: Dict[str, Any],
    x: torch.Tensor,  # (b, s, d)
    cfg: MoEConfig,
    capacity: Optional[int] = None,
    group=None,  # tp group: the experts' ffn dim sharded, the output all-reduced
    ep_fn=None,  # parallel/ep.py's expert apply: (layer, (E, C, d)) -> (E, C, d)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sparse MoE MLP over every (b, s) row: (residual output, aux loss).
    Every row competes for the experts' capacity, in row order. Under a tp
    `group` each rank's down projections are partial sums, reduced before
    the residual add. `ep_fn` runs the experts in place of expert_ffn."""
    b, s, d = x.shape
    n = b * s
    if capacity is None:
        capacity = expert_capacity(cfg, n)
    h = rms_norm(x, layer["mlp_norm"], cfg.rms_eps)
    flat = h.reshape(n, d)
    probs = torch.softmax(flat.float() @ layer["router"], dim=-1)
    dispatch, combine, aux = top_k_dispatch(probs, cfg.top_k, capacity)
    if group is not None:
        flat = tp_region_in(flat, group)
    # (n, E, C) x (n, d) -> (E, C, d): a gather as one product
    expert_in = torch.einsum("nec,nd->ecd", dispatch.to(flat.dtype), flat)
    if ep_fn is not None:
        expert_out = ep_fn(layer, expert_in)
    else:
        expert_out = expert_ffn(layer["w_gate"], layer["w_up"], layer["w_down"], expert_in)
    y = torch.einsum("nec,ecd->nd", combine.to(expert_out.dtype), expert_out)
    if group is not None:
        y = tp_region_out(y, group)
    return x + y.reshape(b, s, d).to(x.dtype), aux


def moe_mlp_block_dense_oracle(layer: Dict[str, Any], x: torch.Tensor,
                               cfg: MoEConfig) -> torch.Tensor:
    """Every expert over every token, weighted by the renormalized top-k
    gate: the no-drop oracle the dispatch must match when no expert
    overflows. Test-only."""
    b, s, d = x.shape
    h = rms_norm(x, layer["mlp_norm"], cfg.rms_eps).reshape(b * s, d)
    probs = torch.softmax(h.float() @ layer["router"], dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = vals[:, : cfg.top_k], idx[:, : cfg.top_k]
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)
    experts = torch.arange(cfg.n_experts, device=x.device)
    weights = torch.zeros_like(probs)
    for j in range(cfg.top_k):
        weights = weights + gate_vals[:, j, None] * (gate_idx[:, j, None] == experts).to(
            probs.dtype)
    outs = expert_ffn(layer["w_gate"], layer["w_up"], layer["w_down"],
                      h[None].expand(cfg.n_experts, *h.shape))  # (E, n, d)
    y = torch.einsum("ne,end->nd", weights.to(outs.dtype), outs)
    return x + y.reshape(b, s, d).to(x.dtype)


def moe_forward(
    params: Dict[str, Any],
    tokens: torch.Tensor,  # (b, s)
    cfg: MoEConfig,
    capacity: Optional[int] = None,
    ep_fn=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Causal forward: (logits (b, s, vocab) f32, the layers' mean aux
    loss). Attention runs through the differentiable dense flash attention
    (K7 forward, K9/K10 backward on CUDA); `ep_fn` as in moe_mlp_block."""
    b, s = tokens.shape
    x = params["embed"][tokens]
    positions = torch.arange(s, device=tokens.device)[None].expand(b, s)
    cos, sin = rotary_frequencies(cfg.head_dim, cfg.max_seq_len, cfg.rope_base, device=x.device)
    # plain stacks split once into per-layer views (as llama.forward does)
    layers = {n: v if isinstance(v, tuple) else list(v.unbind(0))
              for n, v in params["layers"].items()}
    auxes = []
    for l in range(cfg.n_layers):
        layer = layer_view(layers, l)
        x = attention_block(layer, x, cfg, cos, sin, positions)
        x, aux = moe_mlp_block(layer, x, cfg, capacity=capacity, ep_fn=ep_fn)
        auxes.append(aux)
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    logits = _proj(x, params["lm_head"]).float()
    return logits, torch.stack(auxes).mean()


def moe_loss_fn(params: Dict[str, Any], tokens: torch.Tensor, cfg: MoEConfig,
                capacity: Optional[int] = None, ep_fn=None) -> torch.Tensor:
    """Next-token cross entropy plus router_aux_weight times the aux loss."""
    logits, aux = moe_forward(params, tokens[:, :-1], cfg, capacity=capacity, ep_fn=ep_fn)
    targets = tokens[:, 1:].long()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, targets[..., None])[..., 0]
    return nll.mean() + cfg.router_aux_weight * aux
