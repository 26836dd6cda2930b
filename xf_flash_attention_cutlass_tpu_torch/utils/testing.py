"""Dual-reference tolerance helpers: an implementation passes when its max
error against the float32 oracle is at most `mult` times the error that a
low-precision oracle itself commits, plus `atol`. Also the dense attention
oracles that the flash and paged attention kernels are held against."""

import math

import numpy as np
import torch


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def assert_close_2ref(out, out_ref, out_lp, mult: float = 2.0, atol: float = 1e-5):
    """out: impl result; out_ref: float32 oracle; out_lp: low-precision
    (same-dtype) oracle used to calibrate the tolerance."""
    impl_err = max_err(out, out_ref)
    ref_err = max_err(out_lp, out_ref)
    assert impl_err <= mult * ref_err + atol, (
        f"impl max err {impl_err:.6g} > {mult} x reference err {ref_err:.6g} + {atol}"
    )


def alibi_slopes_ref(nheads: int) -> np.ndarray:
    """Standard ALiBi slope schedule: 2^(-8i/n)."""
    return np.asarray(
        [2.0 ** (-8.0 * (i + 1) / nheads) for i in range(nheads)], np.float32
    )


def flash_attention_oracle(q, k, v, *, causal=False, window=(-1, -1), softcap=0.0,
                           kv_lens=None, q_segment_ids=None, kv_segment_ids=None,
                           upcast=True):
    """Dense softmax attention in BHSD (q (b, h, sq, d), k/v (b, h_k, sk, d)),
    written apart from ops/flash_fwd.py and differentiable: the heads are
    repeated over the GQA group, masks built from positions (bottom-right
    aligned, causal = right window 0, keys past kv_lens, segment ids), and
    torch.softmax does the rest. Rows that see no key give O = 0, LSE = -inf
    and zero gradients (no NaN).

    upcast=True is the float32 oracle. upcast=False is the low-precision
    oracle: q times the softmax scale, K, V, the scores, P and the PV product
    each in q's dtype, the softmax in f32. Returns (O (b, h, sq, d) in f32 or
    q's dtype, LSE (b, h, sq) f32)."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    dt = torch.float32 if upcast else q.dtype
    kx = k.to(dt).repeat_interleave(h // k.shape[1], dim=1)
    vx = v.to(dt).repeat_interleave(h // v.shape[1], dim=1)
    s = ((q.to(dt) / math.sqrt(d)).to(dt) @ kx.transpose(-1, -2)).float()
    if softcap > 0.0:
        s = torch.tanh(s / softcap) * softcap
    i = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
    j = torch.arange(sk, device=q.device)[None, :]
    left, right = window[0], (0 if causal else window[1])
    keep = torch.ones((1, 1, sq, sk), dtype=torch.bool, device=q.device)
    if right >= 0:
        keep = keep & (j <= i + right)
    if left >= 0:
        keep = keep & (j >= i - left)
    if kv_lens is not None:
        keep = keep & (j < kv_lens.to(q.device).long()[:, None, None, None])
    if q_segment_ids is not None:
        keep = keep & (q_segment_ids.to(q.device)[:, None, :, None]
                       == kv_segment_ids.to(q.device)[:, None, None, :])
    empty = ~keep.any(dim=-1, keepdim=True)
    s = s.masked_fill(~keep, -torch.inf).masked_fill(empty, 0.0)
    p = torch.softmax(s, dim=-1).masked_fill(empty, 0.0)
    o = p.to(dt) @ vx
    lse = torch.logsumexp(s, dim=-1).masked_fill(empty[..., 0], -torch.inf)
    return o, lse


def paged_attention_oracle(q, k_pool, v_pool, block_tables, kv_lens, *, k_scales=None,
                           v_scales=None, causal=True, upcast=True):
    """Dense softmax attention over the keys each block-table row names,
    written apart from ops/paged.py: the pages are gathered in logical order
    and dequantized, the heads repeated over the GQA group, and the scores
    masked to the first kv_len keys (causal from the bottom right).

    upcast=True is the float32 oracle: every step in f32. upcast=False is
    the low-precision oracle: q times the softmax scale, the dequantized K
    and V, the scores, P and the PV product each rounded to q's dtype, with
    the softmax in f32. Returns (O (b, sq, h, d) in f32 or q's dtype, LSE
    (b, h, sq) f32, -inf on rows that see no key)."""
    b, sq, h, d = q.shape
    h_k = k_pool.shape[1]
    dt = torch.float32 if upcast else q.dtype
    bt = block_tables.long()

    def dense(pool, scales):  # (pages, h_k, page, d) -> (b, h, T, d)
        x = pool[bt].float()  # (b, max_pages, h_k, page, d)
        if scales is not None:
            x = x * scales[bt].float()[..., None]
        x = x.transpose(1, 2).reshape(b, h_k, -1, d)
        return x.repeat_interleave(h // h_k, dim=1).to(dt)

    k, v = dense(k_pool, k_scales), dense(v_pool, v_scales)
    qs = (q.float() / math.sqrt(d)).to(dt).transpose(1, 2)  # (b, h, sq, d)
    s = (qs @ k.transpose(-1, -2)).float()  # (b, h, sq, T)
    kcol = torch.arange(k.shape[2], device=q.device)
    lens = kv_lens.to(device=q.device, dtype=torch.long)[:, None, None, None]
    keep = kcol < lens
    if causal:
        keep = keep & (kcol <= lens - sq + torch.arange(sq, device=q.device)[:, None])
    s = s.masked_fill(~keep, -torch.inf)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None]).nan_to_num(nan=0.0)  # rows with no key: P = 0
    o = (p.to(dt) @ v).transpose(1, 2)
    return o, lse
