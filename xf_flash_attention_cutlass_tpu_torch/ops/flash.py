"""Differentiable dense flash attention: ``flash_fwd`` forward, ``flash_bwd``
backward, as a ``torch.autograd.Function`` (the JAX package's custom VJP).

The forward saves q, k, v, O and LSE with the masks, ALiBi slopes and
positions; the backward recomputes attention from them and replays the
dropout mask from its seed. The gradient with respect to LSE is not
propagated, and slopes, positions and segment ids get none, as in the JAX
package. CUDA tensors run K7 forward and K9/K10 (or K11 with ``fused=True``)
backward; CPU tensors the plain versions.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from xf_flash_attention_cutlass_tpu_torch.ops.flash_bwd import flash_bwd
from xf_flash_attention_cutlass_tpu_torch.ops.flash_fwd import flash_fwd

# tensors that ride beside q, k, v: masks, ALiBi slopes and positions
_AUX = ("kv_lens", "q_segment_ids", "kv_segment_ids", "alibi_slopes", "alibi_row_slopes",
        "q_positions", "kv_positions")


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, cfg, fused, *aux):
        aux_kw = dict(zip(_AUX, aux))
        o, lse = flash_fwd(q, k, v, **aux_kw, **cfg)
        ctx.save_for_backward(q, k, v, o, lse, *aux)
        ctx.cfg, ctx.fused = cfg, fused
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):  # the cotangent of LSE is not propagated
        q, k, v, o, lse, *aux = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, o, lse, do, fused=ctx.fused, **dict(zip(_AUX, aux)),
                               **ctx.cfg)
        return (dq, dk, dv, None, None) + (None,) * len(_AUX)


def flash_attention(
    q: torch.Tensor,  # (b, h, sq, d)
    k: torch.Tensor,  # (b, h_k, sk, d)
    v: torch.Tensor,
    *,
    causal: bool = False,
    window: Tuple[int, int] = (-1, -1),
    softcap: float = 0.0,
    softmax_scale: Optional[float] = None,
    kv_lens: Optional[torch.Tensor] = None,
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    alibi_slopes: Optional[torch.Tensor] = None,  # (h,) or (b, h) f32
    alibi_row_slopes: Optional[torch.Tensor] = None,  # (b, h, sq) f32
    q_positions: Optional[torch.Tensor] = None,
    kv_positions: Optional[torch.Tensor] = None,
    dropout_p: float = 0.0,
    dropout_seed: int = 0,
    fused: Optional[bool] = None,  # the backward's schedule, as in flash_bwd
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Differentiable BHSD flash attention. Returns (O, LSE)."""
    cfg = dict(causal=causal, window=tuple(window), softcap=softcap,
               softmax_scale=softmax_scale, dropout_p=dropout_p, dropout_seed=dropout_seed)
    aux = (kv_lens, q_segment_ids, kv_segment_ids, alibi_slopes, alibi_row_slopes,
           q_positions, kv_positions)
    return _FlashAttention.apply(q, k, v, cfg, fused, *aux)
