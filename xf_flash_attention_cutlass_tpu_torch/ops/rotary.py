"""Rotary position embedding (RoPE) — interleaved (GPT-J) and
contiguous-half (NeoX) layouts, in plain torch as in the JAX package.

``cos``/``sin`` have shape (max_pos, rotary_dim // 2); position ``p`` of a
token selects row ``p``; only the leading ``rotary_dim`` features rotate, the
tail passes through.
"""

from __future__ import annotations

from typing import Optional

import torch

from xf_flash_attention_cutlass_tpu_torch.utils import acc_dtype


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
    acc = acc_dtype(x.dtype)
    c = cos[positions].to(acc)[:, :, None, :]  # (b, s, 1, r/2)
    sn = sin[positions].to(acc)[:, :, None, :]
    xr = x[..., :r].to(acc)
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


def apply_rotary_single(
    x: torch.Tensor,  # (s, d) or (b, s, d): no head axis
    cos: torch.Tensor,
    sin: torch.Tensor,
    positions: Optional[torch.Tensor] = None,  # (b, s); None: 0 .. s - 1
    interleaved: bool = True,
) -> torch.Tensor:
    """apply_rotary for layouts without a head axis."""
    squeeze_b = x.dim() == 2
    if squeeze_b:
        x = x[None]
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
    out = apply_rotary(x[:, :, None, :], cos, sin, positions, interleaved)[:, :, 0]
    return out[0] if squeeze_b else out
