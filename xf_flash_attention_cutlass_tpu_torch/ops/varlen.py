"""Ragged-batch (varlen) flash attention, ported from the JAX package's
``ops/varlen.py`` with its routing kept.

Packed varlen concatenates all sequences into one row axis and masks with
per-token segment ids; the bottom-right causal / window geometry of each
sequence comes back by folding its (len_k - len_q) offset into explicit
query positions. The dense kernel (K7 forward, K9/K10 backward, K8 for the
probability plane) then handles everything; its tile tables skip the tile
pairs of different sequences. (batch, heads) ALiBi slopes become a
per-token slope plane.

Paged varlen right-aligns each sequence's queries into a (b, max_seqlen_q)
rectangle and runs the paged kernel (K1) over the block table; dropout
takes the dense gather of the padded key rectangle instead (the paged
kernel is an inference kernel). The JAX package's ``XFA_PAGED_ROWS_MAX``
split of large query blocks is TPU machinery and is not copied.

Lengths come from cu_seqlens as tensors; no host synchronization is needed
except in ``varlen_paged_attn_probs``, whose packed key count is a shape.
"""

from __future__ import annotations

import logging
from typing import Optional, Tuple

import torch

from xf_flash_attention_cutlass_tpu_torch.ops.flash import flash_attention
from xf_flash_attention_cutlass_tpu_torch.ops.flash_fwd import attention_probs
from xf_flash_attention_cutlass_tpu_torch.ops.paged import paged_attention

logger = logging.getLogger(__name__)

FAR = 2**30  # position of padding tokens: beyond any window


def segments_from_cu_seqlens(cu_seqlens: torch.Tensor, total: int) -> torch.Tensor:
    """Token index -> segment id (int32); tokens past cu_seqlens[-1] get -1."""
    cu = cu_seqlens.to(torch.int64)
    idx = torch.arange(total, dtype=torch.int64, device=cu.device)
    seg = torch.searchsorted(cu, idx, right=True) - 1
    nseq = cu.shape[0] - 1
    valid = (seg >= 0) & (idx < cu[-1])
    return torch.where(valid, seg.clamp_max(nseq - 1), -1).to(torch.int32)


def _row_slopes_from_segments(alibi_slopes: torch.Tensor, qseg: torch.Tensor) -> torch.Tensor:
    """(nseq, h) slopes -> per-token (1, h, total_q) plane: token i takes its
    sequence's slope row; tokens outside every sequence (qseg < 0) get 0
    (their rows are fully masked anyway)."""
    seg_c = qseg.long().clamp(0, alibi_slopes.shape[0] - 1)
    rows = alibi_slopes.float()[seg_c]  # (total_q, h)
    rows = torch.where((qseg >= 0)[:, None], rows, torch.zeros_like(rows))
    return rows.t().contiguous()[None]


def _packed_positions(cu_q, cu_k, total_q, total_k, seqused_k=None):
    """Segment ids and positions of packed queries and keys: the key's index
    within its sequence, and the query's with (len_k - len_q) folded in.
    With seqused_k, keys past the first seqused_k[i] of sequence i get
    segment -2."""
    cu_q, cu_k = cu_q.to(torch.int64), cu_k.to(torch.int64)
    qseg = segments_from_cu_seqlens(cu_q, total_q)
    kseg = segments_from_cu_seqlens(cu_k, total_k)
    qidx = torch.arange(total_q, dtype=torch.int64, device=cu_q.device)
    kidx = torch.arange(total_k, dtype=torch.int64, device=cu_k.device)
    len_q = cu_q[1:] - cu_q[:-1]
    len_k = cu_k[1:] - cu_k[:-1]
    if seqused_k is not None:
        len_k = torch.minimum(len_k, seqused_k.to(device=len_k.device, dtype=torch.int64))
        kc = kseg.long().clamp_min(0)
        kseg = torch.where(kidx - cu_k[kc] < len_k[kc], kseg, -2).to(torch.int32)
    qc = qseg.long().clamp_min(0)
    qpos = torch.where(qseg >= 0, qidx - cu_q[qc] + len_k[qc] - len_q[qc], -FAR)
    kc = kseg.long().clamp_min(0)
    kpos = torch.where(kseg >= 0, kidx - cu_k[kc], FAR)
    return qseg, kseg, qpos.to(torch.int32), kpos.to(torch.int32)


def _slopes(alibi_slopes, qseg):
    """(alibi_slopes, alibi_row_slopes) for the packed kernel: (h,) slopes
    pass through, (batch, h) slopes become a per-token plane."""
    if alibi_slopes is None:
        return None, None
    alibi_slopes = alibi_slopes.float()
    if alibi_slopes.dim() == 2:
        return None, _row_slopes_from_segments(alibi_slopes, qseg)
    return alibi_slopes, None


def flash_attn_varlen(
    q: torch.Tensor,  # (total_q, h, d)
    k: torch.Tensor,  # (total_k, h_k, d)
    v: torch.Tensor,
    cu_seqlens_q: torch.Tensor,  # (b+1,) int
    cu_seqlens_k: torch.Tensor,  # (b+1,) int
    *,
    max_seqlen_q: Optional[int] = None,
    max_seqlen_k: Optional[int] = None,
    seqused_k: Optional[torch.Tensor] = None,  # (b,) int: live keys per sequence
    causal: bool = False,
    window: Tuple[int, int] = (-1, -1),
    softcap: float = 0.0,
    softmax_scale: Optional[float] = None,
    alibi_slopes: Optional[torch.Tensor] = None,  # (h,) or (b, h)
    dropout_p: float = 0.0,
    dropout_seed: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Differentiable packed varlen attention. Returns (out (total_q, h, d),
    lse (h, total_q)), the unpadded LSE layout. The max_seqlen arguments are
    accepted for the reference's signature; the packed layout needs none."""
    del max_seqlen_q, max_seqlen_k
    qseg, kseg, qpos, kpos = _packed_positions(cu_seqlens_q, cu_seqlens_k, q.shape[0],
                                               k.shape[0], seqused_k)
    slopes, row_slopes = _slopes(alibi_slopes, qseg)
    return _packed_attention(q, k, v, qseg, kseg, qpos, kpos, causal=causal, window=window,
                             softcap=softcap, softmax_scale=softmax_scale, alibi_slopes=slopes,
                             alibi_row_slopes=row_slopes, dropout_p=dropout_p,
                             dropout_seed=dropout_seed)


def _packed_attention(q, k, v, qseg, kseg, qpos, kpos, *, causal, window, softcap,
                      softmax_scale, alibi_slopes, dropout_p, dropout_seed,
                      alibi_row_slopes=None):
    """K7 over (1, h, total, d) with segment ids and folded positions."""
    out, lse = flash_attention(
        q.transpose(0, 1)[None], k.transpose(0, 1)[None], v.transpose(0, 1)[None],
        causal=causal, window=window, softcap=softcap, softmax_scale=softmax_scale,
        alibi_slopes=alibi_slopes, alibi_row_slopes=alibi_row_slopes,
        q_segment_ids=qseg[None], kv_segment_ids=kseg[None], q_positions=qpos[None],
        kv_positions=kpos[None], dropout_p=dropout_p, dropout_seed=dropout_seed,
    )
    return out[0].transpose(0, 1), lse[0]


def varlen_attn_probs(
    q: torch.Tensor,  # (total_q, h, d)
    k: torch.Tensor,  # (total_k, h_k, d)
    lse: torch.Tensor,  # (h, total_q) from flash_attn_varlen
    cu_seqlens_q: torch.Tensor,
    cu_seqlens_k: torch.Tensor,
    *,
    seqused_k: Optional[torch.Tensor] = None,
    causal: bool = False,
    window: Tuple[int, int] = (-1, -1),
    softcap: float = 0.0,
    softmax_scale: Optional[float] = None,
    alibi_slopes: Optional[torch.Tensor] = None,
    dropout_p: float = 0.0,
    dropout_seed: int = 0,
) -> torch.Tensor:
    """Packed-layout S_dmask of the varlen entry through K8: the (h,
    total_q, total_k) probability plane, entries across sequences 0 and
    entries the dropout dropped negated. Call it with the inputs, options
    and seed of the flash_attn_varlen that produced `lse`."""
    qseg, kseg, qpos, kpos = _packed_positions(cu_seqlens_q, cu_seqlens_k, q.shape[0],
                                               k.shape[0], seqused_k)
    slopes, row_slopes = _slopes(alibi_slopes, qseg)
    probs = attention_probs(
        q.transpose(0, 1)[None], k.transpose(0, 1)[None], lse[None], causal=causal,
        window=window, softcap=softcap, softmax_scale=softmax_scale, alibi_slopes=slopes,
        alibi_row_slopes=row_slopes, q_segment_ids=qseg[None], kv_segment_ids=kseg[None],
        q_positions=qpos[None], kv_positions=kpos[None], dropout_p=dropout_p,
        dropout_seed=dropout_seed,
    )
    return probs[0]


def flash_attn_varlen_paged(
    q: torch.Tensor,  # (total_q, h, d) packed ragged queries
    k_cache: torch.Tensor,  # (num_blocks, page, h_k, d), the reference's layout
    v_cache: torch.Tensor,
    block_table: torch.Tensor,  # (b, max_pages) int
    cu_seqlens_q: torch.Tensor,  # (b+1,) int
    seqused_k: torch.Tensor,  # (b,) int: live keys per sequence
    *,
    max_seqlen_q: Optional[int] = None,  # bound on one sequence's query count
    causal: bool = False,
    window: Tuple[int, int] = (-1, -1),
    softcap: float = 0.0,
    softmax_scale: Optional[float] = None,
    alibi_slopes: Optional[torch.Tensor] = None,
    dropout_p: float = 0.0,
    dropout_seed: int = 0,
    internal_layout: bool = False,  # pools already (num_blocks, h_k, page, d)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ragged prefill against a paged KV cache. Queries are right-aligned
    into a (b, max_seqlen_q) rectangle and K1 attends each row over its
    live pages; with dropout the padded key rectangle is gathered densely
    and the packed dense kernel runs instead. Returns (out (total_q, h, d),
    lse (h, total_q))."""
    total_q, h, d = q.shape
    b = block_table.shape[0]
    k_pool, v_pool = k_cache, v_cache
    if not internal_layout:  # (num_blocks, page, h_k, d): one transposed copy each
        k_pool, v_pool = k_cache.transpose(1, 2).contiguous(), v_cache.transpose(1, 2).contiguous()
    cu_q = cu_seqlens_q.to(torch.int64)
    seqused_k = seqused_k.to(torch.int32)
    len_q = cu_q[1:] - cu_q[:-1]
    sq_max = min(int(max_seqlen_q) if max_seqlen_q else total_q, total_q)

    if dropout_p > 0.0:
        logger.debug("flash_attn_varlen_paged: dropout requested (the paged kernel is "
                     "inference-only): the DENSE gather path serves it")
        return _varlen_paged_dense_fallback(
            q, k_pool, v_pool, block_table, cu_q, seqused_k, causal=causal, window=window,
            softcap=softcap, softmax_scale=softmax_scale, alibi_slopes=alibi_slopes,
            dropout_p=dropout_p, dropout_seed=dropout_seed)

    # right-align each sequence's queries: padded row j of sequence i is
    # packed index cu_q[i] + j - (sq_max - len_q[i]); the pad rows in front
    # compute attention for positions that are discarded
    j = torch.arange(sq_max, dtype=torch.int64, device=q.device)[None]
    src = (cu_q[:-1, None] + j - (sq_max - len_q[:, None])).clamp(0, total_q - 1)
    q_pad = q[src.reshape(-1)].reshape(b, sq_max, h, d)
    if alibi_slopes is not None:
        # the paged kernel's |qpos - kcol| distances are those of the
        # right-aligned rows; it takes (b, h) slopes as they are
        alibi_slopes = alibi_slopes.float().expand(b, h)
    out_pad, lse_pad = paged_attention(
        q_pad, k_pool, v_pool, block_table, seqused_k, softmax_scale=softmax_scale,
        causal=causal, window=window, softcap=softcap, alibi_slopes=alibi_slopes,
    )  # (b, sq_max, h, d), (b, h, sq_max)

    # back to the packed layouts
    qseg = segments_from_cu_seqlens(cu_q, total_q)
    segc = qseg.long().clamp_min(0)
    qidx = torch.arange(total_q, dtype=torch.int64, device=q.device)
    jj = (qidx - cu_q[segc] + (sq_max - len_q[segc])).clamp(0, sq_max - 1)
    valid = qseg >= 0
    out = torch.where(valid[:, None, None], out_pad[segc, jj], 0.0).to(q.dtype)
    lse = torch.where(valid[:, None], lse_pad[segc, :, jj], -torch.inf).t()
    return out, lse


def _dense_rectangle(k_pool, block_table, seqused_k, cu_q, total_q):
    """The padded key rectangle of a block table, packed: (b * sk, h_k, d)
    keys with their segment ids and positions (keys past seqused_k get
    segment -2), and the queries' segment ids and folded positions."""
    b, max_pages = block_table.shape
    h_k, page, d = k_pool.shape[1:]
    sk = max_pages * page
    kd = k_pool[block_table.long().reshape(-1)].transpose(1, 2).reshape(b * sk, h_k, d)
    kidx = torch.arange(b * sk, dtype=torch.int64, device=k_pool.device)
    kbatch, kwithin = kidx // sk, kidx % sk
    used = seqused_k.to(device=k_pool.device, dtype=torch.int64)
    kseg = torch.where(kwithin < used[kbatch], kbatch, -2).to(torch.int32)
    kpos = torch.where(kseg >= 0, kwithin, FAR).to(torch.int32)
    qseg = segments_from_cu_seqlens(cu_q, total_q)
    segc = qseg.long().clamp_min(0)
    len_q = cu_q[1:] - cu_q[:-1]
    qidx = torch.arange(total_q, dtype=torch.int64, device=k_pool.device)
    qpos = torch.where(qseg >= 0, qidx - cu_q[segc] + used[segc] - len_q[segc], -FAR)
    return kd, qseg, kseg, qpos.to(torch.int32), kpos


def _varlen_paged_dense_fallback(q, k_pool, v_pool, block_table, cu_q, seqused_k, *, causal,
                                 window, softcap, softmax_scale, alibi_slopes, dropout_p=0.0,
                                 dropout_seed=0):
    """Gather the padded key rectangle densely and run the packed kernel:
    the paged route for dropout."""
    total_q, h, d = q.shape
    kd, qseg, kseg, qpos, kpos = _dense_rectangle(k_pool, block_table, seqused_k, cu_q,
                                                  total_q)
    vd, *_ = _dense_rectangle(v_pool, block_table, seqused_k, cu_q, total_q)
    slopes, row_slopes = _slopes(alibi_slopes, qseg)
    return _packed_attention(q, kd, vd, qseg, kseg, qpos, kpos, causal=causal, window=window,
                             softcap=softcap, softmax_scale=softmax_scale, alibi_slopes=slopes,
                             alibi_row_slopes=row_slopes, dropout_p=dropout_p,
                             dropout_seed=dropout_seed)


def varlen_paged_attn_probs(
    q: torch.Tensor,  # (total_q, h, d) packed ragged queries
    k_cache: torch.Tensor,  # (num_blocks, page, h_k, d), the reference's layout
    lse: torch.Tensor,  # (h, total_q) from flash_attn_varlen_paged
    block_table: torch.Tensor,  # (b, max_pages) int
    cu_seqlens_q: torch.Tensor,  # (b+1,) int
    seqused_k: torch.Tensor,  # (b,) int
    *,
    causal: bool = False,
    window: Tuple[int, int] = (-1, -1),
    softcap: float = 0.0,
    softmax_scale: Optional[float] = None,
    alibi_slopes: Optional[torch.Tensor] = None,
    dropout_p: float = 0.0,
    dropout_seed: int = 0,
    internal_layout: bool = False,
) -> torch.Tensor:
    """S_dmask of the paged varlen entry, in the packed-key convention of
    ``varlen_attn_probs``: key column cu_k[i] + j is cache position j of
    sequence i, with cu_k the cumulative seqused_k. K8 recomputes the plane
    on the densely gathered key rectangle, the layout (and so the dropout
    counters) of the dropout route, and the live columns are gathered out.
    Reads seqused_k on the host: the packed key count is a shape."""
    total_q = q.shape[0]
    b, max_pages = block_table.shape
    k_pool = k_cache if internal_layout else k_cache.transpose(1, 2)
    sk = max_pages * k_pool.shape[2]
    kd, qseg, kseg, qpos, kpos = _dense_rectangle(k_pool, block_table, seqused_k,
                                                  cu_seqlens_q.to(torch.int64), total_q)
    slopes, row_slopes = _slopes(alibi_slopes, qseg)
    probs_pad = attention_probs(
        q.transpose(0, 1)[None], kd.transpose(0, 1)[None], lse[None], causal=causal,
        window=window, softcap=softcap, softmax_scale=softmax_scale, alibi_slopes=slopes,
        alibi_row_slopes=row_slopes, q_segment_ids=qseg[None], kv_segment_ids=kseg[None],
        q_positions=qpos[None], kv_positions=kpos[None], dropout_p=dropout_p,
        dropout_seed=dropout_seed,
    )[0]  # (h, total_q, b * sk)
    lens = seqused_k.to(device=q.device, dtype=torch.int64)
    cu_k = torch.cat([lens.new_zeros(1), torch.cumsum(lens, 0)])
    total_k = int(cu_k[-1])
    pseg = segments_from_cu_seqlens(cu_k, total_k).long().clamp_min(0)
    within = torch.arange(total_k, dtype=torch.int64, device=q.device) - cu_k[:-1][pseg]
    return probs_pad[:, :, pseg * sk + within]
