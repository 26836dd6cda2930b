"""Differentiable dense flash attention: ``flash_fwd`` forward, ``flash_bwd``
backward, as a ``torch.autograd.Function`` (the JAX package's custom VJP).

The forward saves q, k, v, O and LSE; the backward recomputes attention from
them. The gradient with respect to LSE is not propagated, as in the JAX
package. CUDA tensors run K7 forward and K9/K10 (or K11 with
``fused=True``) backward; CPU tensors the plain versions.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from xf_flash_attention_cutlass_tpu_torch.ops.flash_bwd import flash_bwd
from xf_flash_attention_cutlass_tpu_torch.ops.flash_fwd import check_not_ported, flash_fwd


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, cfg, fused, kv_lens, q_segment_ids, kv_segment_ids):
        o, lse = flash_fwd(q, k, v, kv_lens=kv_lens, q_segment_ids=q_segment_ids,
                           kv_segment_ids=kv_segment_ids, **cfg)
        ctx.save_for_backward(q, k, v, o, lse, kv_lens, q_segment_ids, kv_segment_ids)
        ctx.cfg, ctx.fused = cfg, fused
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):  # the cotangent of LSE is not propagated
        q, k, v, o, lse, kv_lens, q_seg, kv_seg = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, o, lse, do, kv_lens=kv_lens, q_segment_ids=q_seg,
                               kv_segment_ids=kv_seg, fused=ctx.fused, **ctx.cfg)
        return dq, dk, dv, None, None, None, None, None


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
    alibi_slopes: Optional[torch.Tensor] = None,
    q_positions: Optional[torch.Tensor] = None,
    kv_positions: Optional[torch.Tensor] = None,
    dropout_p: float = 0.0,
    fused: Optional[bool] = None,  # the backward's schedule, as in flash_bwd
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Differentiable BHSD flash attention. Returns (O, LSE)."""
    check_not_ported(alibi_slopes, q_positions, kv_positions, dropout_p)
    cfg = dict(causal=causal, window=tuple(window), softcap=softcap,
               softmax_scale=softmax_scale)
    return _FlashAttention.apply(q, k, v, cfg, fused, kv_lens, q_segment_ids, kv_segment_ids)
