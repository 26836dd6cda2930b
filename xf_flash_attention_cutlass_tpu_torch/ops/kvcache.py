"""KV-cache attention: append, rotary and paged or dense decode, ported from
the JAX package's ``ops/kvcache.py``.

One kernel serves both cache kinds: a dense (b, sk, h_k, d) cache is viewed
as pages of at most DEFAULT_PAGE rows with an identity block table, and the
paged kernel (K1, ops/paged.py) attends over it. The appends are plain
tensor scatters, as the JAX package's are plain jnp scatters; unlike the
JAX package, which returns new arrays, they write the caller's caches in
place, as the torch reference does. Rotary is applied before the append:
queries rotate at cache_seqlens + t when causal or local (else all at
cache_seqlens), new keys at cache_seqlens + t.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from xf_flash_attention_cutlass_tpu_torch.ops.paged import paged_attention
from xf_flash_attention_cutlass_tpu_torch.ops.rotary import apply_rotary
from xf_flash_attention_cutlass_tpu_torch.quant.kv import quantize_kv
from xf_flash_attention_cutlass_tpu_torch.utils import next_multiple

DEFAULT_PAGE = 256  # page rows used when viewing a dense cache as paged


def _slots(cache_seqlens, s_new, block_tables, page):
    """(physical page, row) of every new token, flattened batch-major."""
    t = torch.arange(s_new, dtype=torch.int64, device=block_tables.device)[None]
    pos = cache_seqlens.to(device=block_tables.device, dtype=torch.int64)[:, None] + t
    pe = torch.gather(block_tables.long(), 1, pos // page).reshape(-1)
    return pe, (pos % page).reshape(-1)


def append_kv_paged(
    k_pool: torch.Tensor,  # (num_pages, h_k, page, d), or (L, ...) with layer_idx
    v_pool: torch.Tensor,
    k_new: torch.Tensor,  # (b, s_new, h_k, d)
    v_new: torch.Tensor,
    block_tables: torch.Tensor,  # (b, max_pages) int
    cache_seqlens: torch.Tensor,  # (b,) int: insert position per batch entry
    layer_idx: Optional[int] = None,
    page_size: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scatter new tokens into the paged pools (internal layout), in place.
    Returns the pools."""
    page = int(page_size) if page_size is not None else k_pool.shape[-2]
    b, s_new, h_k, d = k_new.shape
    pe, row = _slots(cache_seqlens, s_new, block_tables, page)
    for pool, new in ((k_pool, k_new), (v_pool, v_new)):
        dst = pool if layer_idx is None else pool[int(layer_idx)]
        dst[pe, :, row] = new.reshape(b * s_new, h_k, d).to(pool.dtype)
    return k_pool, v_pool


def append_kv_paged_quantized(
    k_pool: torch.Tensor,  # (num_pages, h_k, page, d) int8 / fp8 values
    k_scales: torch.Tensor,  # (num_pages, h_k, page[, 1]) f32
    v_pool: torch.Tensor,
    v_scales: torch.Tensor,
    k_new: torch.Tensor,  # (b, s_new, h_k, d) full precision
    v_new: torch.Tensor,
    block_tables: torch.Tensor,
    cache_seqlens: torch.Tensor,
    layer_idx: Optional[int] = None,
    page_size: Optional[int] = None,
):
    """Quantize new tokens per token (quant/kv.quantize_kv) and scatter
    values and scales in place. Returns (k_pool, k_scales, v_pool, v_scales)."""
    page = int(page_size) if page_size is not None else k_pool.shape[-2]
    b, s_new, h_k, d = k_new.shape
    pe, row = _slots(cache_seqlens, s_new, block_tables, page)
    for pool, scales, new in ((k_pool, k_scales, k_new), (v_pool, v_scales, v_new)):
        vals, sc = quantize_kv(new.reshape(b * s_new, h_k, d), pool.dtype)
        dst = pool if layer_idx is None else pool[int(layer_idx)]
        dsc = scales if layer_idx is None else scales[int(layer_idx)]
        dst[pe, :, row] = vals
        dsc[pe, :, row] = sc if dsc.dim() == dst.dim() else sc[..., 0]
    return k_pool, k_scales, v_pool, v_scales


def append_kv_dense(
    k_cache: torch.Tensor,  # (b_cache, sk, h_k, d)
    v_cache: torch.Tensor,
    k_new: torch.Tensor,  # (b, s_new, h_k, d)
    v_new: torch.Tensor,
    cache_seqlens: torch.Tensor,  # (b,) int
    cache_batch_idx: Optional[torch.Tensor] = None,  # (b,) int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write new tokens at cache_seqlens of each (cache_batch_idx) row, in
    place. Returns the caches."""
    b, s_new, h_k, d = k_new.shape
    dev = k_cache.device
    cbi = (torch.arange(b, device=dev) if cache_batch_idx is None
           else cache_batch_idx.to(device=dev, dtype=torch.int64))
    t = torch.arange(s_new, dtype=torch.int64, device=dev)[None]
    pos = (cache_seqlens.to(device=dev, dtype=torch.int64)[:, None] + t).reshape(-1)
    rows = cbi.repeat_interleave(s_new)
    k_cache[rows, pos] = k_new.reshape(-1, h_k, d).to(k_cache.dtype)
    v_cache[rows, pos] = v_new.reshape(-1, h_k, d).to(v_cache.dtype)
    return k_cache, v_cache


def dense_cache_as_paged(cache: torch.Tensor, page: int = DEFAULT_PAGE) -> Tuple[torch.Tensor, int]:
    """(b, sk, h_k, d) -> internal pool (b * pages, h_k, page, d), a copy;
    returns (pool, pages_per_seq). Padding rows are masked by kv_lens."""
    b, sk, h_k, d = cache.shape
    sk_pad = next_multiple(sk, page)
    if sk_pad != sk:
        cache = torch.cat([cache, cache.new_zeros((b, sk_pad - sk, h_k, d))], dim=1)
    pages = sk_pad // page
    pool = cache.reshape(b, pages, page, h_k, d).transpose(2, 3)
    return pool.reshape(b * pages, h_k, page, d).contiguous(), pages


def attention_with_kvcache(
    q: torch.Tensor,  # (b, sq, h, d)
    k_cache: torch.Tensor,  # (b_cache, sk, h_k, d) or (num_blocks, page, h_k, d)
    v_cache: torch.Tensor,
    k_new: Optional[torch.Tensor] = None,  # (b, s_new, h_k, d)
    v_new: Optional[torch.Tensor] = None,
    rotary_cos: Optional[torch.Tensor] = None,  # (max_pos, r/2)
    rotary_sin: Optional[torch.Tensor] = None,
    cache_seqlens=None,  # int or (b,) int
    cache_batch_idx: Optional[torch.Tensor] = None,  # (b,) int
    cache_leftpad: Optional[torch.Tensor] = None,  # (b,) int
    block_table: Optional[torch.Tensor] = None,  # (b, max_blocks) int
    softmax_scale: Optional[float] = None,
    causal: bool = False,
    window_size: Tuple[int, int] = (-1, -1),
    softcap: float = 0.0,
    rotary_interleaved: bool = True,
    alibi_slopes: Optional[torch.Tensor] = None,
    num_splits: int = 0,
    return_softmax_lse: bool = False,
):
    """Decode / append attention against a dense or paged KV cache.

    Returns (out[, lse], k_cache, v_cache), the tuple of the JAX package;
    the caches are the caller's tensors, written in place when k_new /
    v_new are given (the torch reference's in-place update)."""
    b, sq, h, d = q.shape
    paged = block_table is not None
    dev = q.device
    window_size = tuple(int(w) for w in window_size)

    if cache_seqlens is None:
        if k_new is not None:
            raise ValueError("cache_seqlens is required when appending new KV")
        sk_total = block_table.shape[1] * k_cache.shape[1] if paged else k_cache.shape[1]
        cache_seqlens = torch.full((b,), sk_total, dtype=torch.int32, device=dev)
    elif not torch.is_tensor(cache_seqlens) or cache_seqlens.dim() == 0:
        cache_seqlens = torch.full((b,), int(cache_seqlens), dtype=torch.int32, device=dev)
    else:
        cache_seqlens = cache_seqlens.to(device=dev, dtype=torch.int32)

    s_new = 0 if k_new is None else k_new.shape[1]
    if rotary_cos is not None and s_new > 0:
        t_q = torch.arange(sq, dtype=torch.int32, device=dev)[None]
        if causal or window_size[0] >= 0 or window_size[1] >= 0:
            q_pos = cache_seqlens[:, None] + t_q
        else:
            q_pos = cache_seqlens[:, None].expand(b, sq)
        q = apply_rotary(q, rotary_cos, rotary_sin, q_pos, rotary_interleaved)
        t_k = torch.arange(s_new, dtype=torch.int32, device=dev)[None]
        k_new = apply_rotary(k_new, rotary_cos, rotary_sin, cache_seqlens[:, None] + t_k,
                             rotary_interleaved)

    if paged:
        bt = block_table.to(torch.int32)
        # (num_blocks, page, h_k, d) viewed in the internal layout: the
        # append writes through the views into the caller's caches
        k_pool, v_pool = k_cache.transpose(1, 2), v_cache.transpose(1, 2)
        if k_new is not None:
            append_kv_paged(k_pool, v_pool, k_new, v_new, bt, cache_seqlens)
        k_pool, v_pool = k_pool.contiguous(), v_pool.contiguous()
    else:
        if k_new is not None:
            append_kv_dense(k_cache, v_cache, k_new, v_new, cache_seqlens, cache_batch_idx)
        kc, vc = k_cache, v_cache
        if cache_batch_idx is not None:
            kc, vc = kc[cache_batch_idx.long()], vc[cache_batch_idx.long()]
        page = min(DEFAULT_PAGE, next_multiple(kc.shape[1], 8))
        k_pool, pages = dense_cache_as_paged(kc, page)
        v_pool, _ = dense_cache_as_paged(vc, page)
        bt = (torch.arange(b, dtype=torch.int32, device=dev)[:, None] * pages
              + torch.arange(pages, dtype=torch.int32, device=dev)[None])

    out, lse = paged_attention(
        q, k_pool, v_pool, bt, cache_seqlens + s_new, softmax_scale=softmax_scale,
        causal=causal, window=window_size, softcap=softcap, alibi_slopes=alibi_slopes,
        cache_leftpad=cache_leftpad, num_splits=num_splits,
    )
    if return_softmax_lse:
        return out, lse, k_cache, v_cache
    return out, k_cache, v_cache
