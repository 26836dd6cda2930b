"""Ulysses sequence parallelism: all-to-all context parallelism (the JAX
package's ``parallel/ulysses.py``).

Where ring attention (``parallel/ring.py``) rotates K/V chunks around the
group with an (O, LSE) merge per hop, Ulysses re-shards with all-to-alls:
the sequence-sharded q, k and v become head-sharded, each rank runs the
dense ``flash_attention`` (K7 forward, K9/K10 backward) over the WHOLE
sequence for h / n of the heads, and O and LSE go back to sequence shards,
each by an exchange of its own. Every exchange is differentiable
(``collectives.all_to_all``: its backward is the inverse exchange).

The kv heads reach the ranks by one of three routes:
- h_k % n == 0: the plain exchange; q heads [i*h/n, (i+1)*h/n) pair with
  kv heads [i*h_k/n, ...), since h / h_k is kept on every rank;
- 1 < h_k and n % h_k == 0 (grouped GQA): each kv head repeated n / h_k
  times, so that one exchange lands kv head i // (n / h_k) on rank i,
  whose q heads all map to it;
- otherwise (h_k == 1, or h_k not dividing n): the full K/V gathered over
  the sequence (``collectives.all_gather``, whose backward is the
  reduce-scatter) and this rank's heads selected. It logs at WARNING, or at
  DEBUG for h_k == 1, where the gather moves the bytes the grouped route
  would.

Usage: q, k, v sequence-sharded over the group's ranks in rank order, each
rank holding (b, h, s_local, d) with rank i owning tokens [i*s_local,
(i+1)*s_local).
"""

from __future__ import annotations

import logging
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from xf_flash_attention_cutlass_tpu_torch.ops.flash import flash_attention
from xf_flash_attention_cutlass_tpu_torch.utils.collectives import (
    all_gather,
    all_to_all,
    check_transport,
)

logger = logging.getLogger(__name__)


def ulysses_attention(
    q: torch.Tensor,  # (b, h, s_local, d): this rank's sequence chunk
    k: torch.Tensor,  # (b, h_k, s_local, d)
    v: torch.Tensor,
    group,
    *,
    causal: bool = True,
    softmax_scale: Optional[float] = None,
    window: Tuple[int, int] = (-1, -1),
    softcap: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact, differentiable attention over the sequence that the group's
    ranks hold in rank order. Returns this rank's (O, LSE) chunk, as
    ring_attention does."""
    h, h_k = q.shape[1], k.shape[1]
    n = dist.get_world_size(group)
    if h % n:
        raise ValueError(f"q heads {h} must be divisible by axis size {n}")
    check_transport(q, group)

    def to_heads(x):  # (b, heads, s_local, d) -> (b, heads / n, s, d)
        return all_to_all(x, group, split_dim=1, concat_dim=2)

    qh = to_heads(q)
    if h_k % n == 0:
        kh, vh = to_heads(k), to_heads(v)
    elif 1 < h_k and n % h_k == 0:
        kh, vh = (to_heads(x.repeat_interleave(n // h_k, dim=1)) for x in (k, v))
    else:
        logger.log(logging.DEBUG if h_k == 1 else logging.WARNING,
                   "ulysses_attention: h_k=%d vs axis size %d takes the full-KV all-gather "
                   "(O(h_k*s*d) per-device traffic)", h_k, n)
        h_local = h // n
        heads = (dist.get_rank(group) * h_local
                 + torch.arange(h_local, device=k.device)) // (h // h_k)
        kh, vh = (all_gather(x, group, dim=2).index_select(1, heads) for x in (k, v))
    o_h, lse_h = flash_attention(qh, kh, vh, causal=causal, window=window, softcap=softcap,
                                 softmax_scale=softmax_scale)
    o = all_to_all(o_h, group, split_dim=2, concat_dim=1)
    lse = all_to_all(lse_h, group, split_dim=2, concat_dim=1)
    return o, lse
