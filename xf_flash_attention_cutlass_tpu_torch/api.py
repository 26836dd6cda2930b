"""Public API in the reference's (batch, seq, heads, dim) layout, ported from
the JAX package's ``api.py``: ``flash_attn_func``, ``flash_attn_kvpacked_func``,
``flash_attn_varlen_func``, ``flash_attn_varlen_kvpacked_func`` and
``flash_attn_with_kvcache``, with the same validation and messages.

The wrappers move the heads axis to the kernels' (batch, heads, seq, dim)
and call the ops: dense attention (K7 forward, K9/K10 backward, K8 for the
probabilities), packed varlen (the same kernels with segment ids and
positions), paged varlen and the KV cache (K1). CUDA tensors run the
kernels, which take bf16 or fp16 (K1: bf16 queries); any other dtype raises
TypeError naming the kernel, and nothing falls back to a plain version. CPU
tensors run the plain versions in any dtype the validation admits.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from xf_flash_attention_cutlass_tpu_torch.ops.flash import flash_attention
from xf_flash_attention_cutlass_tpu_torch.ops.flash_fwd import attention_probs
from xf_flash_attention_cutlass_tpu_torch.ops.kvcache import attention_with_kvcache
from xf_flash_attention_cutlass_tpu_torch.ops.varlen import (
    flash_attn_varlen,
    flash_attn_varlen_paged,
    varlen_attn_probs,
    varlen_paged_attn_probs,
)

MAX_HEADDIM = 256  # the reference's dispatch ladder (flash_fwd_launch_template.h)
_DTYPES = (torch.float16, torch.bfloat16, torch.float32)


def _check(cond: bool, msg: str):
    """Host-side input validation, the reference's TORCH_CHECK layer."""
    if not cond:
        raise ValueError(msg)


def _check_qkv(q, k, v, q_rank: int):
    _check(q.dim() == q_rank, f"q must be rank {q_rank}, got shape {tuple(q.shape)}")
    _check(k.dim() == q_rank and v.dim() == q_rank,
           f"k/v must be rank {q_rank}, got {tuple(k.shape)} / {tuple(v.shape)}")
    _check(q.dtype == k.dtype == v.dtype,
           f"q/k/v dtypes must match, got {q.dtype}/{k.dtype}/{v.dtype}")
    _check(q.dtype in _DTYPES, f"unsupported dtype {q.dtype}; use fp16/bf16/fp32")
    _check(k.shape == v.shape, f"k and v shapes must match: {tuple(k.shape)} vs {tuple(v.shape)}")
    h, hk, d = q.shape[-2], k.shape[-2], q.shape[-1]
    _check(k.shape[-1] == d, f"head dims differ: q {d} vs k {k.shape[-1]}")
    _check(h % hk == 0, f"q heads ({h}) must be a multiple of kv heads ({hk})")
    _check(0 < d <= MAX_HEADDIM, f"head_dim must be in (0, {MAX_HEADDIM}], got {d}")


def flash_attn_func(
    q: torch.Tensor,  # (b, sq, h, d)
    k: torch.Tensor,  # (b, sk, h_k, d)
    v: torch.Tensor,  # (b, sk, h_k, d)
    dropout_p: float = 0.0,
    causal: bool = False,
    window_size: Tuple[int, int] = (-1, -1),
    softcap: float = 0.0,
    alibi_slopes: Optional[torch.Tensor] = None,
    deterministic: bool = False,
    return_attn_probs: bool = False,
    softmax_scale: Optional[float] = None,
    dropout_seed: int = 0,
):
    """Dense flash attention, differentiable. ``deterministic`` is accepted
    for the reference's signature: the default two-pass backward sums
    without atomics. With ``return_attn_probs=True`` returns (out, lse,
    S_dmask): the (b, h, sq, sk) probability plane (K8) with the entries the
    seeded dropout dropped negated."""
    del deterministic
    _check_qkv(q, k, v, 4)
    _check(q.shape[0] == k.shape[0], f"batch mismatch: {q.shape[0]} vs {k.shape[0]}")
    _check(0.0 <= dropout_p < 1.0, f"dropout_p must be in [0, 1), got {dropout_p}")
    opts = dict(causal=causal, window=window_size, softcap=softcap, alibi_slopes=alibi_slopes,
                dropout_p=dropout_p, dropout_seed=dropout_seed, softmax_scale=softmax_scale)
    qt, kt = q.transpose(1, 2), k.transpose(1, 2)
    out, lse = flash_attention(qt, kt, v.transpose(1, 2), **opts)
    out = out.transpose(1, 2)
    if return_attn_probs:
        return out, lse, attention_probs(qt.detach(), kt.detach(), lse, **opts)
    return out


def flash_attn_kvpacked_func(
    q: torch.Tensor,  # (b, sq, h, d)
    kv: torch.Tensor,  # (b, sk, 2, h_k, d)
    dropout_p: float = 0.0,
    softmax_scale: Optional[float] = None,
    causal: bool = False,
    window_size: Tuple[int, int] = (-1, -1),
    softcap: float = 0.0,
    alibi_slopes: Optional[torch.Tensor] = None,
    deterministic: bool = False,
    return_softmax: bool = False,
    dropout_seed: int = 0,
):
    """Dense attention over a packed (K, V) tensor: kv[:, :, 0] is K and
    kv[:, :, 1] is V."""
    _check(kv.dim() == 5 and kv.shape[2] == 2,
           f"kv must be (b, sk, 2, h_k, d), got {tuple(kv.shape)}")
    return flash_attn_func(
        q, kv[:, :, 0], kv[:, :, 1], dropout_p=dropout_p, softmax_scale=softmax_scale,
        causal=causal, window_size=window_size, softcap=softcap, alibi_slopes=alibi_slopes,
        deterministic=deterministic, return_attn_probs=return_softmax,
        dropout_seed=dropout_seed,
    )


def flash_attn_varlen_kvpacked_func(
    q,  # (total_q, h, d)
    kv,  # (total_k, 2, h_k, d)
    cu_seqlens_q,
    cu_seqlens_k,
    max_seqlen_q: int,
    max_seqlen_k: int,
    dropout_p: float = 0.0,
    softmax_scale: Optional[float] = None,
    causal: bool = False,
    window_size: Tuple[int, int] = (-1, -1),
    softcap: float = 0.0,
    alibi_slopes=None,
    deterministic: bool = False,
    return_attn_probs: bool = False,
    dropout_seed: int = 0,
):
    """Ragged-batch attention over packed (K, V)."""
    _check(kv.dim() == 4 and kv.shape[1] == 2,
           f"kv must be (total_k, 2, h_k, d), got {tuple(kv.shape)}")
    return flash_attn_varlen_func(
        q, kv[:, 0], kv[:, 1], cu_seqlens_q, cu_seqlens_k, max_seqlen_q, max_seqlen_k,
        dropout_p=dropout_p, softmax_scale=softmax_scale, causal=causal,
        window_size=window_size, softcap=softcap, alibi_slopes=alibi_slopes,
        deterministic=deterministic, return_attn_probs=return_attn_probs,
        dropout_seed=dropout_seed,
    )


def flash_attn_varlen_func(
    q,  # (total_q, h, d)
    k,  # (total_k, h_k, d), or (num_blocks, page, h_k, d) with block_table
    v,
    cu_seqlens_q,
    cu_seqlens_k,
    max_seqlen_q: int,
    max_seqlen_k: int,
    dropout_p: float = 0.0,
    softmax_scale: Optional[float] = None,
    causal: bool = False,
    window_size: Tuple[int, int] = (-1, -1),
    softcap: float = 0.0,
    alibi_slopes=None,
    deterministic: bool = False,
    return_attn_probs: bool = False,
    block_table=None,
    seqused_k=None,  # (b,) int: live keys per sequence
    dropout_seed: int = 0,
):
    """Ragged-batch flash attention. With a block_table, k and v are page
    pools and cu_seqlens_k gives the cache lengths (unless seqused_k does);
    the queries run through K1, or the packed dense kernels with dropout.
    With ``return_attn_probs`` returns (out, lse, S_dmask): the packed
    (h, total_q, total_k) plane of ``varlen_attn_probs`` or, paged,
    ``varlen_paged_attn_probs``."""
    del deterministic
    _check(q.dim() == 3, f"varlen q must be (total_q, h, d), got {tuple(q.shape)}")
    _check(0.0 <= dropout_p < 1.0, f"dropout_p must be in [0, 1), got {dropout_p}")
    opts = dict(causal=causal, window=window_size, softcap=softcap,
                softmax_scale=softmax_scale, alibi_slopes=alibi_slopes, dropout_p=dropout_p,
                dropout_seed=dropout_seed)
    if block_table is not None:
        _check(k.dim() == 4, f"paged k must be (num_blocks, page, h_k, d), got {tuple(k.shape)}")
        _check(block_table.dim() == 2,
               f"block_table must be (b, max_pages), got {tuple(block_table.shape)}")
        if seqused_k is None:
            seqused_k = (cu_seqlens_k[1:] - cu_seqlens_k[:-1]).to(torch.int32)
        out, lse = flash_attn_varlen_paged(q, k, v, block_table, cu_seqlens_q, seqused_k,
                                           max_seqlen_q=max_seqlen_q, **opts)
        if return_attn_probs:
            s_dmask = varlen_paged_attn_probs(q.detach(), k, lse, block_table, cu_seqlens_q,
                                              seqused_k, **opts)
            return out, lse, s_dmask
        return out
    out, lse = flash_attn_varlen(q, k, v, cu_seqlens_q, cu_seqlens_k, max_seqlen_q=max_seqlen_q,
                                 max_seqlen_k=max_seqlen_k, seqused_k=seqused_k, **opts)
    if return_attn_probs:
        s_dmask = varlen_attn_probs(q.detach(), k.detach(), lse, cu_seqlens_q, cu_seqlens_k,
                                    seqused_k=seqused_k, **opts)
        return out, lse, s_dmask
    return out


def flash_attn_with_kvcache(
    q,  # (b, sq, h, d)
    k_cache,  # (b, sk, h_k, d) dense or (num_blocks, page, h_k, d) paged
    v_cache,
    k=None,
    v=None,
    rotary_cos=None,
    rotary_sin=None,
    cache_seqlens=None,
    cache_batch_idx=None,
    cache_leftpad=None,
    block_table=None,
    softmax_scale=None,
    causal: bool = False,
    window_size: Tuple[int, int] = (-1, -1),
    softcap: float = 0.0,
    rotary_interleaved: bool = True,
    alibi_slopes=None,
    num_splits: int = 0,
    return_softmax_lse: bool = False,
):
    """Paged or dense KV-cache decode with append. Returns (out, k_cache,
    v_cache), or (out, lse, k_cache, v_cache) with return_softmax_lse, as
    the JAX package does; the caches are the caller's tensors, updated in
    place when k / v are given, as in the torch reference."""
    _check(q.dim() == 4, f"q must be (b, sq, h, d), got {tuple(q.shape)}")
    _check(k_cache.dim() == 4, f"k_cache must be rank 4, got {tuple(k_cache.shape)}")
    _check(k_cache.shape == v_cache.shape,
           f"k_cache/v_cache shapes differ: {tuple(k_cache.shape)} vs {tuple(v_cache.shape)}")
    _check(q.shape[-1] == k_cache.shape[-1],
           f"head dims differ: q {q.shape[-1]} vs cache {k_cache.shape[-1]}")
    _check(q.shape[2] % k_cache.shape[2] == 0,
           f"q heads ({q.shape[2]}) must be a multiple of cache kv heads "
           f"({k_cache.shape[2]})")
    if block_table is not None:
        _check(block_table.dim() == 2 and block_table.shape[0] == q.shape[0],
               f"block_table must be (b, max_pages) with b={q.shape[0]}, "
               f"got {tuple(block_table.shape)}")
        _check(cache_batch_idx is None,
               "cache_batch_idx is incompatible with a paged cache "
               "(reference skips this combination too, test.py:1377)")
    if (k is None) != (v is None):
        raise ValueError("k and v must be given together")
    if k is not None:
        _check(cache_seqlens is not None, "cache_seqlens is required when appending new KV")

    return attention_with_kvcache(
        q, k_cache, v_cache, k_new=k, v_new=v, rotary_cos=rotary_cos, rotary_sin=rotary_sin,
        cache_seqlens=cache_seqlens, cache_batch_idx=cache_batch_idx,
        cache_leftpad=cache_leftpad, block_table=block_table, softmax_scale=softmax_scale,
        causal=causal, window_size=window_size, softcap=softcap,
        rotary_interleaved=rotary_interleaved, alibi_slopes=alibi_slopes,
        num_splits=num_splits, return_softmax_lse=return_softmax_lse,
    )
