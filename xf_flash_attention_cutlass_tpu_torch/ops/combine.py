"""(O, LSE) split/merge algebra — the LSE-weighted combine of split-KV
partials, in plain torch as in the JAX package (small elementwise work):

    LSE = logsumexp_i(LSE_i)
    O   = sum_i exp(LSE_i - LSE) * O_i

Empty partials (LSE_i = -inf) contribute nothing; if every partial is empty,
O = 0 and LSE = -inf. Each O_i is already normalized within its split.
"""

from __future__ import annotations

from typing import Tuple

import torch

from xf_flash_attention_cutlass_tpu_torch.utils import acc_dtype


def combine_partials(
    o_parts: torch.Tensor,  # (n_splits, ..., d)
    lse_parts: torch.Tensor,  # (n_splits, ...)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge n split-KV partials along axis 0. Returns (O, LSE) in f32 (f64
    for f64 partials)."""
    acc = acc_dtype(o_parts.dtype)
    lse_parts = lse_parts.to(acc)
    m = lse_parts.amax(dim=0)  # -inf if all empty
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    w = torch.exp(lse_parts - m_safe)
    w = torch.where(torch.isfinite(lse_parts), w, torch.zeros_like(w))
    sumw = w.sum(dim=0)
    has = sumw > 0
    lse = torch.where(
        has, m_safe + torch.log(torch.where(has, sumw, torch.ones_like(sumw))),
        torch.full_like(sumw, -torch.inf),
    )
    o = (w.unsqueeze(-1) * o_parts.to(acc)).sum(dim=0)
    denom = torch.where(has, sumw, torch.ones_like(sumw)).unsqueeze(-1)
    o = torch.where(has.unsqueeze(-1), o / denom, torch.zeros_like(o))
    return o, lse


def merge_two(
    o1: torch.Tensor, lse1: torch.Tensor, o2: torch.Tensor, lse2: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pairwise merge — the streaming form of combine_partials."""
    lse1 = lse1.float()
    lse2 = lse2.float()
    m = torch.maximum(lse1, lse2)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    zero = torch.zeros_like(m)
    w1 = torch.where(torch.isfinite(lse1), torch.exp(lse1 - m_safe), zero)
    w2 = torch.where(torch.isfinite(lse2), torch.exp(lse2 - m_safe), zero)
    sumw = w1 + w2
    has = sumw > 0
    lse = torch.where(
        has, m_safe + torch.log(torch.where(has, sumw, torch.ones_like(sumw))),
        torch.full_like(sumw, -torch.inf),
    )
    denom = torch.where(has, sumw, torch.ones_like(sumw))
    o = (w1.unsqueeze(-1) * o1.float() + w2.unsqueeze(-1) * o2.float()) / denom.unsqueeze(-1)
    o = torch.where(has.unsqueeze(-1), o, torch.zeros_like(o))
    return o, lse
