"""Rotary position embedding (RoPE) — interleaved (GPT-J) and
contiguous-half (NeoX) layouts, in plain torch as in the JAX package.

``cos``/``sin`` have shape (max_pos, rotary_dim // 2); position ``p`` of a
token selects row ``p``; only the leading ``rotary_dim`` features rotate, the
tail passes through.
"""

from __future__ import annotations

import torch


def apply_rotary(
    x: torch.Tensor,  # (b, s, h, d)
    cos: torch.Tensor,  # (max_pos, r/2)
    sin: torch.Tensor,  # (max_pos, r/2)
    positions: torch.Tensor,  # (b, s) int absolute positions
    interleaved: bool = True,
) -> torch.Tensor:
    """Rotate the first 2*(r/2) features of x by position-dependent angles."""
    orig_dtype = x.dtype
    b, s, h, d = x.shape
    half = cos.shape[-1]
    r = 2 * half
    if r > d:
        raise ValueError(f"rotary_dim {r} exceeds head_dim {d}")
    positions = positions.long().clamp(0, cos.shape[0] - 1)
    c = cos[positions].float()[:, :, None, :]  # (b, s, 1, r/2)
    sn = sin[positions].float()[:, :, None, :]
    xr = x[..., :r].float()
    tail = x[..., r:]
    if interleaved:
        x1 = xr[..., 0::2]
        x2 = xr[..., 1::2]
        rot = torch.stack([x1 * c - x2 * sn, x1 * sn + x2 * c], dim=-1).reshape(b, s, h, r)
    else:
        x1 = xr[..., :half]
        x2 = xr[..., half:]
        rot = torch.cat([x1 * c - x2 * sn, x1 * sn + x2 * c], dim=-1)
    return torch.cat([rot.to(orig_dtype), tail], dim=-1)


def rotary_frequencies(
    rotary_dim: int,
    max_pos: int,
    base: float = 10000.0,
    dtype=torch.float32,
    device=None,
):
    """Standard (cos, sin) tables of shape (max_pos, rotary_dim//2)."""
    exps = torch.arange(0, rotary_dim, 2, dtype=torch.float32, device=device) / rotary_dim
    inv_freq = 1.0 / (base ** exps)
    t = torch.arange(max_pos, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)
    return torch.cos(freqs).to(dtype), torch.sin(freqs).to(dtype)
