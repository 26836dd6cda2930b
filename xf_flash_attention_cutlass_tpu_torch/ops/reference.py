"""Plain-torch attention reference, the JAX package's ops/reference.py: the
dense einsum oracle ``attention_ref`` and its mask and bias constructors.

Layout of the reference API: q (batch, seqlen_q, heads, head_dim); k and v
(batch, seqlen_k, kv_heads, head_dim) with heads % kv_heads == 0 (GQA/MQA).
Windows and padding are bottom-right aligned: query row i sees key column j
when i + sk - sq - left <= j <= i + sk - sq + right.
"""

from __future__ import annotations

import math

import torch


def _lengths(n: int, padding_mask, device) -> torch.Tensor:
    """The true length per batch entry, (b, 1, 1, 1), or n as a scalar."""
    if padding_mask is None:
        return torch.tensor(n, dtype=torch.int64, device=device)
    return padding_mask.sum(-1).to(torch.int64).reshape(-1, 1, 1, 1)


def _columns(seqlen_k: int, key_leftpad, device) -> torch.Tensor:
    """Key column indices (1, 1, 1, sk), counted from each entry's leftpad
    ((b, 1, 1, sk)); columns before the leftpad get 2**30."""
    col = torch.arange(seqlen_k, dtype=torch.int64, device=device).reshape(1, 1, 1, seqlen_k)
    if key_leftpad is not None:
        pad = key_leftpad.to(device=device, dtype=torch.int64).reshape(-1, 1, 1, 1)
        col = torch.where(col >= pad, col - pad, torch.full_like(col, 2**30))
    return col


def construct_local_mask(
    seqlen_q: int,
    seqlen_k: int,
    window_size=(-1, -1),
    query_padding_mask=None,  # (b, sq) bool, True = real token
    key_padding_mask=None,  # (b, sk) bool
    key_leftpad=None,  # (b,) int
    device=None,
) -> torch.Tensor:
    """True where the score is masked OUT (outside the local/causal window)."""
    if device is None:
        device = next((t.device for t in (query_padding_mask, key_padding_mask, key_leftpad)
                       if t is not None), torch.device("cpu"))
    row = torch.arange(seqlen_q, dtype=torch.int64, device=device)[:, None]
    col = _columns(seqlen_k, key_leftpad, device)
    sk = _lengths(seqlen_k, key_padding_mask, device)
    sq = _lengths(seqlen_q, query_padding_mask, device)
    if window_size[0] < 0:
        return col > row + sk - sq + window_size[1]
    sk_full = torch.full_like(col, seqlen_k) if key_padding_mask is None else sk
    return torch.logical_or(col > torch.minimum(row + sk - sq + window_size[1], sk_full),
                            col < row + sk - sq - window_size[0])


def attn_bias_from_alibi_slopes(
    slopes,  # (b, h) or (h,)
    seqlen_q: int,
    seqlen_k: int,
    query_padding_mask=None,
    key_padding_mask=None,
    causal: bool = False,
    key_leftpad=None,
) -> torch.Tensor:
    """ALiBi bias, -slope * |i + sk - sq - j| ((b, h, sq, sk)); causal: the
    slope times the key's offset from the last key, (b, h, 1, sk)."""
    if slopes.dim() == 1:
        slopes = slopes[None, :]
    device = slopes.device
    slopes = slopes[:, :, None, None].float()
    if causal:
        bias = torch.arange(-seqlen_k + 1, 1, dtype=torch.float32, device=device)
        return bias[None, None, None, :] * slopes
    row = torch.arange(seqlen_q, dtype=torch.int64, device=device)[:, None]
    col = _columns(seqlen_k, key_leftpad, device)
    sk = _lengths(seqlen_k, key_padding_mask, device)
    sq = _lengths(seqlen_q, query_padding_mask, device)
    return -slopes * (row + sk - sq - col).abs().float()


def attention_ref(
    q,  # (b, sq, h, d)
    k,  # (b, sk, h_k, d)
    v,  # (b, sk, h_k, d)
    query_padding_mask=None,  # (b, sq) bool, True = keep
    key_padding_mask=None,  # (b, sk) bool
    attn_bias=None,  # broadcastable to (b, h, sq, sk)
    dropout_p: float = 0.0,
    dropout_mask=None,  # (b, h, sq, sk) bool, True = keep
    causal: bool = False,
    window_size=(-1, -1),
    softcap: float = 0.0,
    upcast: bool = True,
    reorder_ops: bool = False,
    key_leftpad=None,
    softmax_scale=None,
):
    """Einsum softmax attention oracle. Returns (output (b, sq, h, d), the
    softmax probabilities (b, h, sq, sk) after the masks and before dropout
    and its scaling), both in q's dtype. upcast computes in f32;
    reorder_ops scales k instead of q."""
    if causal:
        window_size = (window_size[0], 0)
    dtype_og = q.dtype
    if upcast:
        q, k, v = q.float(), k.float(), v.float()
    seqlen_q, seqlen_k = q.shape[1], k.shape[1]
    g = q.shape[2] // k.shape[2]
    k = k.repeat_interleave(g, dim=2)
    v = v.repeat_interleave(g, dim=2)
    d = q.shape[-1]
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(d)
    if not reorder_ops:
        scores = torch.einsum("bthd,bshd->bhts", q * scale, k)
    else:
        scores = torch.einsum("bthd,bshd->bhts", q, k * scale)
    if softcap > 0:
        scores = torch.tanh(scores / softcap) * softcap
    if key_padding_mask is not None:
        scores = scores.masked_fill(~key_padding_mask[:, None, None, :], -math.inf)
    local_mask = None
    if window_size[0] >= 0 or window_size[1] >= 0:
        local_mask = construct_local_mask(seqlen_q, seqlen_k, window_size, query_padding_mask,
                                          key_padding_mask, key_leftpad=key_leftpad,
                                          device=q.device)
        scores = scores.masked_fill(local_mask, -math.inf)
    if attn_bias is not None:
        scores = scores + attn_bias
    attention = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    # fully masked rows give exp(-inf - -inf) = NaN: zero them
    attention = torch.nan_to_num(attention, nan=0.0)
    denom = attention.sum(-1, keepdim=True)
    attention = torch.where(denom > 0, attention / torch.where(denom > 0, denom, 1.0), 0.0)
    attention = attention.to(v.dtype)
    if local_mask is not None:
        attention = attention.masked_fill(local_mask.all(dim=-1, keepdim=True), 0.0)
    if query_padding_mask is not None:
        attention = attention.masked_fill(~query_padding_mask[:, None, :, None], 0.0)
    dropout_scaling = 1.0 / (1 - dropout_p)
    attention_drop = attention
    if dropout_mask is not None:
        attention_drop = attention.masked_fill(~dropout_mask, 0.0)
    output = torch.einsum("bhts,bshd->bthd", attention_drop, v * dropout_scaling)
    if query_padding_mask is not None:
        output = output.masked_fill(~query_padding_mask[:, :, None, None], 0.0)
    return output.to(dtype_og), attention.to(dtype_og)
